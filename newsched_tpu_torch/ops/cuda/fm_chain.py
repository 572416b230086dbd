"""The FM channelizer chain as ONE kernel (reference:
newsched_tpu/ops/pallas/fm_chain.py ``fm_chain_step_planes``, with its
``pipelined`` variant and its ``warm`` recompute for time shards,
``fm_chain_gen_step``, the same chain with its input generated inside, and
``fm_chain_gen_warm_step``, that one's stateless per-shard form).

Fuses the flagship model's whole per-batch pipeline (BASELINE config #2:
M-channel PFB -> per-channel quadrature demod -> per-channel decimating
audio FIR) into a single pass over the input; the kernel is
``csrc/fm_chain.cu``, whose header says how it maps onto the H100.

Layout: the stream is planes rows, (n, 2M) f32, row k = [re | im] of input
samples x[kM-(M-1) .. kM] (the rows of the PFB commutator matrix V,
continued across batches). Per row t:

    fold:   acc[t] = sum_q c2[q] * vp[t + off + q]      vp = [halo; vb]
    DFT:    Y[t] = acc[t] @ [[Wr, Wi], [-Wi, Wr]]        (the kernels: an FFT)
    demod:  aud[t] = atan2(Im, Re)(conj(Y[t-1]) * Y[t]) * gain, Y[-1] = prev0
    audio:  out[o] = sum_k ataps[k] * aud[o*decim - k], aud[<0] from tail0

State kept in the reference's layouts: ``prev`` is the last Y row
[re | im]; ``tail`` the last A-1 aud rows, duplicated in both halves.

The audio stage runs as ``ag`` bands (K3ag, the reference's banded audio
Toeplitz) where ``_pick_audio_groups`` says so: 1 by default, as in the
reference; the outputs are the same bit for bit either way.

Precision: the TPU kernel offers accuracy tiers (``split3``, HIGHEST) that
exist because its matrix unit works in bf16 passes. Here every value of
``precision`` computes in FP32 throughout, with the degree-9 atan2
polynomial: at least as accurate as every TPU tier.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build, noise
from newsched_tpu_torch.ops.cuda.mathfns import ATAN_COEFFS, atan2_plain
from newsched_tpu_torch.ops.cuda.planes_fft import CHANNELS, planes_fft_table

PRECISIONS = ("split3", "highest", "high", "default")
WIDTHS = tuple(2 * m for m in CHANNELS)  # planes lanes 2M of K3, K5, K6:
# M = 64 P, P = 1 .. 16, the planes FFT's widths (planes_fft.CHANNELS)
STREAM_W = 896  # the widest chain_tile_stream instance (M = 448); past it
# chain_tile_wide, the width a run-time value
WIDE_ROWS = 16  # rows a pass of chain_tile_wide (csrc kWideRows)
FLAGSHIP_W = 128  # K3p's and the ablation's one width (M = 64)
_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_SM_SMEM = 233472  # bytes of shared memory an H100 SM holds for its blocks
_SM_THREADS = 2048  # threads an SM holds
_THREADS = 256  # threads of a chain block
# t_min of a batch whose rows before it are all real stream rows: further
# back than any block reaches, so no block takes the stream-start branch
_FAR_PAST = -(1 << 30)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def planes_taps(c: np.ndarray) -> np.ndarray:
    """(L, M) arm-fold coefficients -> (L, 2M) for the planes layout."""
    c = np.asarray(c, np.float32)
    return np.concatenate([c, c], axis=1)


def planes_dft_matrix(M: int) -> np.ndarray:
    """(2M, 2M) real matrix computing the channelizer phase combine on the
    planes layout: [ar | ai] @ [[Wr, Wi], [-Wi, Wr]] = [yr | yi]."""
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * np.exp(-2j * np.pi * k / M)[None, :]
    Wr, Wi = W.real.astype(np.float32), W.imag.astype(np.float32)
    top = np.concatenate([Wr, Wi], axis=1)
    bot = np.concatenate([-Wi, Wr], axis=1)
    return np.concatenate([top, bot], axis=0)


def audio_toeplitz(ataps: np.ndarray, tile: int, decim: int) -> np.ndarray:
    """(tile//decim, A-1+tile) matrix H with H[o, s] = ataps[A-1 + o*decim - s]
    (zero outside [0, A)): y[o] = sum_s H[o, s] * [tail; aud][s] is the
    streaming decimating FIR for one tile with an (A-1)-row tail."""
    t = np.asarray(ataps, np.float32)
    A = t.shape[0]
    n_o = tile // decim
    H = np.zeros((n_o, A - 1 + tile), np.float32)
    for o in range(n_o):
        base = A - 1 + o * decim
        for tt in range(A):
            H[o, base - tt] = t[tt]
    return H


def _pick_audio_groups(tile: int, decim: int, A: int) -> int:
    """The audio stage's band count ``ag`` (K3ag, the reference's banded
    audio Toeplitz): 1, as in the reference, whose TPU measured ag = 2 and
    4 slower at the flagship's shape. A caller that wants the banded
    stage replaces this function (the reference's callers monkeypatch
    theirs); K3, K5 and K6 read it at every call, K3p never. The outputs
    do not depend on it: each band sums only its nonzero taps in ag = 1's
    order (csrc/fm_chain.cu, stage 4)."""
    return 1


def _audio_groups(tile: int, decim: int, A: int) -> int:
    """``_pick_audio_groups``' choice, checked: 1, 2 or 4 bands, each a
    whole number of audio outputs (``tile // ag`` a multiple of decim, as
    the reference's shapes imply)."""
    ag = int(_pick_audio_groups(tile, decim, A))
    if ag not in (1, 2, 4) or tile % ag or (tile // ag) % decim:
        raise ValueError(f"audio groups {ag}: tile {tile} // ag must be a "
                         f"multiple of the audio decimation {decim} "
                         f"(ag in 1, 2, 4)")
    return ag


def _count_bands(fn, ag: int) -> None:
    """K3ag's launches, per band count, on the wrapper that launched it."""
    if ag > 1:
        name = f"ag{ag}_launches"
        setattr(fn, name, getattr(fn, name) + 1)


def _pick_tile(n_out: int, tile: int, decim: int) -> int:
    if n_out % tile != 0:
        if n_out <= tile:
            tile = n_out
        else:
            tile = next(t for t in range(tile, 0, -1) if n_out % t == 0)
    if tile % decim != 0:
        raise ValueError(f"tile {tile} not divisible by audio decim {decim}")
    return tile


class FmChainConsts(NamedTuple):
    """The chain's constants as tensors on one device: fold taps (L, 2M),
    DFT matrix (2M, 2M; the plain versions' product), audio taps (A,) and
    the kernels' FFT twiddles (4, M; ``planes_fft_table``, None where M is
    not one the kernels take), which the CUDA wrappers require."""

    c2: torch.Tensor
    w2: torch.Tensor
    ataps: torch.Tensor
    fft: torch.Tensor | None


def fm_chain_consts(arm_c: np.ndarray, ataps: np.ndarray,
                    device) -> FmChainConsts:
    """arm_c: (L, M) fold coefficients (the reference's ``fold_c``);
    ataps: (A,) audio FIR taps."""
    M = int(np.asarray(arm_c).shape[1])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    fft = planes_fft_table(M)
    return FmChainConsts(t(planes_taps(arm_c)), t(planes_dft_matrix(M)),
                         t(np.asarray(ataps, np.float32)),
                         None if fft is None else t(fft))


def fm_chain_step_planes_plain(vb, halo, prev0, tail0, consts: FmChainConsts,
                               decim: int, gain: float, warm: int = 0,
                               ag: int = 1, tile: int | None = None,
                               nd: int = 1):
    """The plain PyTorch version of ``fm_chain_step_planes``: the same sums,
    written over whole tensors. warm > 0 keeps the reference's own
    formulation: the halo's last ``warm`` rows run through the chain from
    the junction state passed (zeros) and their audio is dropped; with nd
    > 1, shard by shard, shard d > 0's halo the warm + H8 rows before it
    in [halo; vb], and the last shard's prev and tail returned. ag > 1
    (K3ag) is the reference's banded audio stage: each tile of ``tile``
    rows as ``ag`` products of one shared shifted Toeplitz
    (``audio_toeplitz(ataps, tile // ag, decim)``) against the rows
    [g*T/ag, g*T/ag + T/ag + A-1) of the tile's [tail; aud]."""
    if nd > 1:
        n_loc, hr = vb.shape[0] // nd, halo.shape[0]
        vp = torch.cat([halo, vb])
        outs = [fm_chain_step_planes_plain(
            vb[d * n_loc:(d + 1) * n_loc], vp[d * n_loc:d * n_loc + hr],
            prev0, tail0, consts, decim, gain, warm, ag, tile)
            for d in range(nd)]
        return torch.cat([o[0] for o in outs]), outs[-1][1], outs[-1][2]
    if warm:
        H8 = halo.shape[0] - warm
        aud, prev, tail = fm_chain_step_planes_plain(
            torch.cat([halo[H8:], vb]), halo[:H8], prev0, tail0, consts, decim,
            gain, ag=ag, tile=tile)
        return aud[warm // decim:], prev, tail
    L, W = consts.c2.shape
    M = W // 2
    A = consts.ataps.shape[0]
    n, H8 = vb.shape[0], halo.shape[0]
    vp = torch.cat([halo, vb])
    off = H8 - (L - 1)
    acc = consts.c2[0] * vp[off:off + n]
    for q in range(1, L):
        acc = acc + consts.c2[q] * vp[off + q:off + q + n]
    Y = acc @ consts.w2
    P = torch.cat([prev0, Y[:-1]])
    ar, ai, yr, yi = P[:, :M], P[:, M:], Y[:, :M], Y[:, M:]
    aud = atan2_plain(ar * yi - ai * yr, ar * yr + ai * yi) * gain
    audfull = torch.cat([tail0[:, :M], aud])  # row s <-> aud[s - (A-1)]
    n_o = n // decim
    if ag > 1:
        # band b (tile b // ag, group b % ag) is rows [b*Tg, b*Tg + Tg + A-1)
        # of audfull; H[o] @ band, its structural zeros skipped: tap k of
        # row o sits at column A-1 + o*decim - k, and the taps are summed
        # in the order of the ag = 1 sum below, as the kernel sums them
        Tg = tile // ag
        H = torch.as_tensor(audio_toeplitz(consts.ataps.cpu().numpy(), Tg,
                                           decim), device=vb.device)
        bands = audfull.unfold(0, Tg + A - 1, Tg)  # (n/Tg, M, Tg + A - 1)
        o = torch.arange(Tg // decim, device=vb.device)
        out = torch.zeros((n // Tg, Tg // decim, M), dtype=torch.float32,
                          device=vb.device)
        for k in range(A):
            s = A - 1 + o * decim - k
            out = out + H[o, s][:, None] * bands[:, :, s].transpose(1, 2)
        out = out.reshape(n_o, M)
    else:
        out = torch.zeros((n_o, M), dtype=torch.float32, device=vb.device)
        for k in range(A):
            s = A - 1 - k
            out = out + consts.ataps[k] * audfull[s:s + n_o * decim:decim]
    tail = aud[n - (A - 1):]
    return out, Y[n - 1:].clone(), torch.cat([tail, tail], dim=1)


def fm_chain_step_planes(vb: torch.Tensor, halo: torch.Tensor,
                         prev0: torch.Tensor, tail0: torch.Tensor,
                         consts: FmChainConsts, decim: int, gain: float,
                         warm: int = 0, tile: int | None = None,
                         precision="split3", pipelined: bool = False,
                         nd: int = 1):
    """Run one batch of the fused chain on the planes-rows stream format.

    Args:
      vb: (n, 2M) f32 — this batch's planes rows.
      halo: (warm + H8, 2M) f32 — the rows immediately PRECEDING vb in
        stream order (zeros at stream start); H8 = round8(L-1). With warm 0
        only its last L-1 rows feed the fold. Next batch's halo is vb's own
        last warm + H8 rows.
      prev0/tail0: (1, 2M) / (A-1, 2M) f32 carried demod/audio state; with
        warm > 0 pass zeros: the state is rebuilt from the halo.
      consts: ``fm_chain_consts(arm_c, ataps, device)``.
      decim: audio decimation; gain: demod gain.
      warm: 0, or (a time shard, which carries no state) a multiple of the
        tile >= ceil(A/decim)*decim: the reference recomputes that many
        rows of output before the batch from a zero junction and drops
        them. The kernel instead rebuilds each block's junction from the
        halo's rows, as it does inside a batch, so the audio equals the
        unsharded stream's bit for bit and no row is computed only to be
        dropped. The returned prev/tail are the true end-of-batch state.
      tile: rows per CUDA block tile (shrunk to a divisor of n as the
        reference does; decim must divide it; at M > 64 shrunk again to a
        divisor whose block fits in shared memory, ``_fit_tile``). Outputs
        do not depend on it. None: 128, the faster of 128
        and 256 at the flagship shape on an H100; pipelined, 64, within 4%
        of 128 there (PERF.md).
      precision: accepted for the reference's signature; FP32 always.
      pipelined: the reference's software-pipelined variant (K3p): each
        CUDA block walks several consecutive tiles in order, carries the
        demod/audio junction from tile to tile instead of rebuilding it,
        and copies the next tile's window while the current one computes.
        The same values bit for bit; tile must then be a multiple of 32
        (64 or 128 at M=64: the block holds two windows). Built for M = 64
        only: other widths raise.
      nd: with warm > 0, the batch's time shards of n/nd rows each (the
        sharded fused graph's step): the audio equals the nd per-shard
        calls', each with the warm + H8 rows before its shard as its halo,
        concatenated, bit for bit, and the tile is picked at n/nd rows as
        theirs is. One launch takes them all: with warm > 0 every block
        already rebuilds its junction from the rows before its tile, so
        over the whole batch with shard 0's halo a block reads what the
        per-shard launch of its shard reads, where those rows lie in the
        batch itself. Only the plain version goes shard by shard.

    Returns (audio (n//decim, M) f32, prev (1, 2M), tail (A-1, 2M)).

    The kernels take M = 64 P channels, P = 1 .. 16 (64 to 1024,
    ``WIDTHS``); other widths raise (ROADMAP.md Queue 3, R1).
    CPU tensors take the plain version; CUDA tensors launch
    ``fm_chain_planes_launch`` (csrc/fm_chain.cu, K3; K3ag where
    ``_pick_audio_groups`` gives ag > 1), or with ``pipelined``
    ``fm_chain_pipe_launch`` (K3p, never banded).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    L, W = (int(d) for d in consts.c2.shape)
    M = W // 2
    A = int(consts.ataps.shape[0])
    n = int(vb.shape[0])
    H8 = _round8(L - 1)
    warm, nd = int(warm), int(nd)
    if nd < 1 or n % nd or (nd > 1 and not warm):
        raise ValueError(f"nd {nd}: time shards of a batch of {n} rows take "
                         f"warm > 0 and n a multiple of nd")
    tile = _pick_tile(n // nd, tile or (64 if pipelined else 128), decim)
    if not pipelined:
        tile = _fit_tile(tile, W, A, L, decim, decim)
    if warm:
        _check_warm(warm, tile, A, decim)
    _check_audio_tail(A, n, tile if pipelined else n)
    if tile < H8:
        raise ValueError(f"tile {tile} < H8 {H8} (batch rows must be >= {H8})")
    if int(halo.shape[0]) != warm + H8:
        raise ValueError(f"halo rows {halo.shape[0]} != warm+H8 = {warm + H8}")
    if pipelined and (tile % 32 or tile < L - 1):
        raise ValueError(f"pipelined: tile {tile} must be a multiple of 32 "
                         f"and >= L-1 = {L - 1}")
    ag = 1 if pipelined else _audio_groups(tile, decim, A)
    if vb.device.type == "cpu":
        return fm_chain_step_planes_plain(vb, halo, prev0, tail0, consts,
                                          decim, gain, warm, ag, tile, nd)
    t_min = _FAR_PAST if warm else 0
    if pipelined:
        return _pipe(vb, halo, prev0, tail0, consts, decim, gain, tile, None,
                     t_min)
    _check_kernel_shape(W, tile, A, L, ag, decim)
    dev = vb.device
    _check_chain_tensors(dev, [("vb", vb, (n, W)),
                               ("halo", halo, (warm + H8, W))],
                         prev0, tail0, consts)
    aud, prev, tail = _chain_outputs(n, decim, M, A, dev)
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_planes_launch(
            vb.data_ptr(), halo.data_ptr(), prev0.data_ptr(),
            tail0.data_ptr(), consts.c2.data_ptr(), consts.fft.data_ptr(),
            consts.ataps.data_ptr(), aud.data_ptr(), prev.data_ptr(),
            tail.data_ptr(), n, M, L, H8, A, int(decim), tile, ag, warm + H8,
            t_min, float(gain), ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_planes_launch")
    fm_chain_step_planes.launches += 1
    _count_bands(fm_chain_step_planes, ag)
    return aud, prev, tail


fm_chain_step_planes.launches = 0
fm_chain_step_planes.ag2_launches = 0
fm_chain_step_planes.ag4_launches = 0


def _check_audio_tail(A: int, n: int, rows: int) -> None:
    """The audio FIR's A-1 rows of carried history must fit in the
    ``n``-row batch, and for K3p, which carries it from tile to tile, in
    its tile (``rows``); any other tile takes it, however short."""
    if A - 1 > min(n, rows):
        what = "batch rows" if rows >= n else "pipelined tile"
        raise ValueError(f"audio tail {A - 1} exceeds the {what} "
                         f"{min(n, rows)}")


def _check_warm(warm: int, tile: int, A: int, decim: int) -> None:
    """The reference's conditions on ``warm``."""
    if warm % tile:
        raise ValueError(f"warm {warm} must be a multiple of tile {tile}")
    need = -(-A // decim) * decim
    if warm < need:
        raise ValueError(
            f"warm {warm} too small: need >= ceil(A/decim)*decim = {need} "
            f"recomputed rows to rebuild demod+audio state")


def _pipe_smem(tile: int, A: int, L: int, W: int) -> int:
    """Shared bytes of a K3p block: the tile buffer, the stage buffer for
    the next window and two Y rows."""
    return (_tile_rows(tile, A, L) + tile + L - 1 + 2) * W * 4


@functools.lru_cache(maxsize=None)
def _pipe_tiles_per_block(n_tiles: int, smem: int, sms: int) -> int:
    """Tiles a K3p block walks: as few as fill every SM once at the blocks
    per SM that its shared memory allows (one at the flagship's tiles)."""
    per_sm = max(1, min(_SM_THREADS // _THREADS, _SM_SMEM // (smem + 1024)))
    return -(-n_tiles // (sms * per_sm))


def _pipe(vb, halo, prev0, tail0, consts: FmChainConsts, decim: int,
          gain: float, tile: int, tiles_per_block: int | None,
          t_min: int = 0):
    """Launch K3p (``fm_chain_step_planes(pipelined=True)``); the tiles a
    block walks default to ``_pipe_tiles_per_block`` and change no output
    bit. ``t_min``: 0, or ``_FAR_PAST`` for a time shard (warm > 0)."""
    L, W = (int(d) for d in consts.c2.shape)
    M, A, n = W // 2, int(consts.ataps.shape[0]), int(vb.shape[0])
    H8 = _round8(L - 1)
    hrows = int(halo.shape[0])
    if W != FLAGSHIP_W:
        raise ValueError(f"pipelined: planes width {W}; K3p is built for "
                         f"M=64 channels ({FLAGSHIP_W} lanes)")
    smem = _pipe_smem(tile, A, L, W)
    if smem > _SMEM_MAX:
        raise ValueError(f"tile {tile}: {smem} bytes of shared memory, the "
                         f"H100 allows {_SMEM_MAX}; pass a smaller tile")
    dev = vb.device
    _check_chain_tensors(dev, [("vb", vb, (n, W)), ("halo", halo, (hrows, W))],
                         prev0, tail0, consts)
    if vb.data_ptr() % 16:
        raise ValueError("vb: the pipelined kernel copies 16-byte words; "
                         "its data must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = tiles_per_block or _pipe_tiles_per_block(n // tile, smem, sms)
    aud, prev, tail = _chain_outputs(n, decim, M, A, dev)
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_pipe_launch(
            vb.data_ptr(), halo.data_ptr(), prev0.data_ptr(),
            tail0.data_ptr(), consts.c2.data_ptr(), consts.fft.data_ptr(),
            consts.ataps.data_ptr(), aud.data_ptr(), prev.data_ptr(),
            tail.data_ptr(), n, M, L, H8, A, int(decim), tile, hrows, t_min,
            int(G), float(gain), ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_pipe_launch")
    fm_chain_step_planes.pipe_launches += 1
    return aud, prev, tail


fm_chain_step_planes.pipe_launches = 0


def _tile_rows(tile: int, A: int, L: int) -> int:
    """Shared-memory rows of a chain block: the (tile + A)-row tile padded
    to 32-row passes, or the tile + A + L - 1 input rows folded into it."""
    return max(-(-(tile + A) // 32) * 32, tile + A + L - 1)


def _stream_window_rows(L: int) -> int:
    """chain_tile_stream's window rows (csrc stream_window_rows): a pass's
    32 + L-1 input rows, at least 48 (rows 32 .. 47 hold its aud rows)."""
    return 32 + max(L - 1, 16)


def _chain_smem(tile: int, A: int, L: int, ag: int, decim: int,
                W: int = FLAGSHIP_W) -> int:
    """Shared bytes of a K3, K5 or K6 block (csrc chain_smem_floats): at
    128 lanes the tile buffer, and with ag > 1 room past its tile + A rows
    for K3ag's band table (the buffer's padding holds it at the flagship's
    shape); up to ``STREAM_W``, chain_tile_stream's window of one pass, the
    Y row kept for the pass below and the tile's tile/decim x M audio
    accumulators; wider, chain_tile_wide's 16 folded rows, that Y row and
    the accumulators."""
    if W > STREAM_W:
        return ((WIDE_ROWS + 1) * W + tile // decim * (W // 2)) * 4
    if W != FLAGSHIP_W:
        return ((_stream_window_rows(L) + 1) * W + tile // decim * (W // 2)) * 4
    floats = _tile_rows(tile, A, L) * W
    if ag > 1:
        tg = tile // ag
        floats = max(floats, (tile + A) * W + tg // decim * (tg + A - 1))
    return floats * 4


def _fit_tile(tile: int, W: int, A: int, L: int, decim: int,
              unit: int) -> int:
    """The largest divisor of ``tile`` that is a multiple of ``unit``, at
    least H8 rows and whose block fits in shared memory at W lanes: the
    tile itself up to 128 rows at every width the kernels take for the
    flagship's A and L. The tile may be shorter than the audio FIR's A-1
    rows of history: each block rebuilds A rows before its tile, reading
    tail0 only for rows before the batch, whichever tile they fall in. The
    tile changes no output bit; the wrapper's checks see ``tile`` where
    none fits."""
    least = max(_round8(L - 1), 1)
    return next((d for d in range(tile, least - 1, -1)
                 if tile % d == 0 and d % unit == 0
                 and _chain_smem(d, A, L, 1, decim, W) <= _SMEM_MAX), tile)


def _check_kernel_shape(W: int, tile: int, A: int, L: int, ag: int,
                        decim: int) -> None:
    """What K3, K5 and K6 take: 2M in ``WIDTHS`` (M = 64 .. 1024) and a
    block that fits in shared memory."""
    if W not in WIDTHS:
        raise ValueError(f"planes width {W} (M={W // 2}): the CUDA kernels "
                         f"take M = 64 P channels, P = 1 .. 16 (64 to "
                         f"{CHANNELS[-1]}); other widths are ROADMAP.md "
                         f"Queue 3, R1")
    smem = _chain_smem(tile, A, L, ag, decim, W)
    if smem > _SMEM_MAX:
        raise ValueError(f"tile {tile}: {smem} bytes of shared memory, the "
                         f"H100 allows {_SMEM_MAX}; pass a smaller tile")


def _check_chain_tensors(dev, inputs, prev0, tail0, consts) -> None:
    L, W = (int(d) for d in consts.c2.shape)
    A = int(consts.ataps.shape[0])
    if consts.fft is None:
        raise ValueError("consts.fft: the kernels take the DFT as an FFT and "
                         "need its twiddle table; build the constants with "
                         "fm_chain_consts")
    for name, t, shape in [*inputs, ("prev0", prev0, (1, W)),
                           ("tail0", tail0, (A - 1, W)),
                           ("c2", consts.c2, (L, W)),
                           ("fft", consts.fft, (4, W // 2)),
                           ("ataps", consts.ataps, (A,))]:
        _build.check_tensor(t, name, device=dev, shape=shape)


def _chain_outputs(n: int, decim: int, M: int, A: int, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((n // decim, M), **f32),
            torch.empty((1, 2 * M), **f32), torch.empty((A - 1, 2 * M), **f32))


def fm_chain_gen_step_plain(g0, amp, carry0, prev0, tail0,
                            consts: FmChainConsts, decim: int, gain: float,
                            n_loc: int, seed: int = 0, draws: int = 3,
                            ag: int = 1, tile: int | None = None):
    """The plain PyTorch version of ``fm_chain_gen_step``: the noise
    stream's plain version scaled by ``amp``, then the chain's (ag, tile:
    its audio stage, as ``fm_chain_step_planes_plain``)."""
    W = int(consts.c2.shape[1])
    dev = carry0.device
    rows = noise.gaussian_rows_plain(g0, n_rows=n_loc, width=W, seed=seed,
                                     device=dev, draws=draws) \
        * torch.as_tensor(amp, dtype=torch.float32, device=dev)
    aud, prev, tail = fm_chain_step_planes_plain(rows, carry0, prev0, tail0,
                                                 consts, decim, gain, ag=ag,
                                                 tile=tile)
    return aud, prev, tail, rows[n_loc - carry0.shape[0]:].clone()


def fm_chain_gen_step(g0, amp, carry0: torch.Tensor, prev0: torch.Tensor,
                      tail0: torch.Tensor, consts: FmChainConsts, decim: int,
                      gain: float, n_loc: int, tile: int = 128, seed: int = 0,
                      draws: int = 3):
    """One batch of the fused chain with its input GENERATED in the kernel:
    the live noise flagship as one source kernel.

    Args:
      g0: the batch's first absolute 64-row group of the noise stream (the
        source's int64 counter on the device, which the kernel reads from
        the card, or a host int; ops/cuda/noise.py).
      amp: float32 scalar amplitude (a 0-dim tensor on the device, or a
        number); the rows are ``gaussian_rows(...) * amp``.
      carry0: (H8, 2M) the previous batch's last H8 generated rows (zeros
        at stream start): the fold's halo.
      prev0/tail0, consts, decim, gain: as ``fm_chain_step_planes``.
      n_loc: rows to generate and process (a multiple of the tile).
      tile: rows per CUDA block, shrunk to a divisor of n_loc; decim must
        divide it. Unlike the TPU kernel it need not be a multiple of 64
        rows: generation is position-pure per element. Outputs do not
        depend on it.
      seed, draws: the noise stream (ops/cuda/noise.py).

    Returns (audio (n_loc//decim, M), prev (1, 2M), tail (A-1, 2M),
    carry (H8, 2M)): bit for bit what ``gaussian_rows`` * amp fed to
    ``fm_chain_step_planes`` at the same tile gives, with carry the last
    H8 rows of that input.

    CPU tensors take the plain version; CUDA tensors launch
    ``fm_chain_gen_launch`` (csrc/fm_chain.cu).
    """
    L, W = (int(d) for d in consts.c2.shape)
    M = W // 2
    A = int(consts.ataps.shape[0])
    n_loc = int(n_loc)
    H8 = _round8(L - 1)
    tile = _fit_tile(_pick_tile(n_loc, tile, decim), W, A, L, decim, decim)
    _check_audio_tail(A, n_loc, n_loc)
    if tile < H8:
        raise ValueError(f"tile {tile} < H8 {H8} (batch rows must be >= {H8})")
    if int(carry0.shape[0]) != H8:
        raise ValueError(f"carry rows {carry0.shape[0]} != H8 = {H8}")
    ag = _audio_groups(tile, decim, A)
    dev = carry0.device
    if dev.type == "cpu":
        return fm_chain_gen_step_plain(g0, amp, carry0, prev0, tail0, consts,
                                       decim, gain, n_loc, seed, draws, ag,
                                       tile)
    _check_kernel_shape(W, tile, A, L, ag, decim)
    amp = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    _check_chain_tensors(dev, [("amp", amp, (1,)), ("carry0", carry0, (H8, W))],
                         prev0, tail0, consts)
    args = noise.stream_args(seed, draws)
    g = noise.device_group(g0, dev)
    aud, prev, tail = _chain_outputs(n_loc, decim, M, A, dev)
    carry = torch.empty((H8, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_gen_launch(
            g.data_ptr(), *args, amp.data_ptr(), carry0.data_ptr(),
            prev0.data_ptr(),
            tail0.data_ptr(), consts.c2.data_ptr(), consts.fft.data_ptr(),
            consts.ataps.data_ptr(), aud.data_ptr(), prev.data_ptr(),
            tail.data_ptr(), carry.data_ptr(), n_loc, M, L, H8, A, int(decim),
            tile, ag, float(gain), ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_gen_launch")
    fm_chain_gen_step.launches += 1
    _count_bands(fm_chain_gen_step, ag)
    return aud, prev, tail, carry


fm_chain_gen_step.launches = 0
fm_chain_gen_step.ag2_launches = 0
fm_chain_gen_step.ag4_launches = 0


def _zero_state(dev, A: int, W: int) -> tuple:
    """Zero (1, W) and (A-1, W) junction rows on ``dev``, made once: the
    stream-start state K6 reads at the stream's first row."""
    key = (dev, A, W)
    if key not in _ZEROS:
        _ZEROS[key] = (torch.zeros((1, W), dtype=torch.float32, device=dev),
                       torch.zeros((A - 1, W), dtype=torch.float32, device=dev))
    return _ZEROS[key]


_ZEROS: dict = {}


def fm_chain_gen_warm_step_plain(g0, amp, consts: FmChainConsts, decim: int,
                                 gain: float, n_loc: int, warm: int,
                                 seed: int = 0, draws: int = 3,
                                 goff: int = 0, ag: int = 1,
                                 tile: int | None = None, nd: int = 1):
    """The plain PyTorch version of ``fm_chain_gen_warm_step``, the
    reference's own non-hardware formulation, shard by shard: for shard d
    < nd the stream's rows [base - warm - H8, base + n_loc) (groups before
    the stream read 0), base = g0 + goff + d n_loc/64 groups, scaled by
    ``amp``, through K3's warm > 0 plain version from a zero junction (ag,
    tile: its audio stage, as ``fm_chain_step_planes_plain``); the shards'
    audio in order."""
    L, W = (int(d) for d in consts.c2.shape)
    A = int(consts.ataps.shape[0])
    hr = warm + _round8(L - 1)
    dev = consts.c2.device
    amp = torch.as_tensor(amp, dtype=torch.float32, device=dev)
    z1, zt = _zero_state(dev, A, W)
    auds = []
    for d in range(int(nd)):
        base = noise.group_tensor(g0, dev) + int(goff) \
            + d * (n_loc // noise.GROUP_ROWS)
        rows = noise.gaussian_rows_plain(base, n_rows=hr + n_loc, width=W,
                                         seed=seed, device=dev, draws=draws,
                                         mask_pre=True, row0=-hr) * amp
        auds.append(fm_chain_step_planes_plain(rows[hr:], rows[:hr], z1, zt,
                                               consts, decim, gain, warm, ag,
                                               tile)[0])
    return torch.cat(auds)


def fm_chain_gen_warm_step(g0, amp, consts: FmChainConsts, decim: int,
                           gain: float, n_loc: int, *, warm: int,
                           tile: int = 128, seed: int = 0, draws: int = 3,
                           goff: int = 0, nd: int = 1):
    """SEGMENTS of the live chain with no carried state at all: the audio
    of stream rows [G*64, G*64 + nd * n_loc) of the noise stream, G = g0 +
    goff (g0: the source's int64 group counter on the device, which the
    kernel reads from the card, or a host int; goff: a host count of
    groups), x ``amp``, as ``nd`` time shards of ``n_loc`` rows (1: one
    segment). The sharded live flagship's step: one launch takes every
    shard of the batch (shard d's base the counter plus goff + d n_loc/64
    groups), and needs no input, no carries and no collectives. The kernel
    finds each shard's stream start from the base it reads.

    The reference regenerates its fold halo and recomputes ``warm`` rows of
    output from a zero junction, then drops them. Each CUDA block here
    already rebuilds its junction from the rows before its tile, so K6
    generates exactly those rows (before the base too, groups before the
    stream reading 0) and computes nothing it drops: ``warm`` is checked
    as the reference checks it (a multiple of the tile, at least
    ceil(A/decim)*decim) and not otherwise used. The audio equals K5's at
    the same rows bit for bit: the same routine on the same rows, and where
    the shard starts at the stream's first row the same stream-start state.

    tile: rows per CUDA block, shrunk to a divisor of n_loc; a multiple of
    64 rows and of decim, as the reference requires. Outputs do not depend
    on it, nor on nd: the audio of nd shards equals the shards' audio one
    by one, in order. Returns audio (nd * n_loc//decim, M) f32.

    ``consts`` on the CPU take the plain version; on a CUDA device this
    launches ``fm_chain_gen_warm_launch`` (csrc/fm_chain.cu, K6).
    """
    L, W = (int(d) for d in consts.c2.shape)
    M = W // 2
    A = int(consts.ataps.shape[0])
    n_loc, warm = int(n_loc), int(warm)
    H8 = _round8(L - 1)
    tile = _fit_tile(_pick_tile(n_loc, tile, decim), W, A, L, decim,
                     int(np.lcm(noise.GROUP_ROWS, decim)))
    _check_warm(warm, tile, A, decim)
    if tile % noise.GROUP_ROWS:
        raise ValueError(f"tile {tile} not a multiple of the noise group "
                         f"({noise.GROUP_ROWS} rows)")
    _check_audio_tail(A, n_loc, n_loc)
    if tile < H8:
        raise ValueError(f"tile {tile} < H8 {H8} (batch rows must be >= {H8})")
    if H8 > noise.GROUP_ROWS:
        raise ValueError(f"H8 {H8} > one noise group ({noise.GROUP_ROWS} "
                         f"rows): first-tile halo regeneration spans one group")
    nd = int(nd)
    if nd < 1:
        raise ValueError(f"nd {nd}: at least one shard")
    ag = _audio_groups(tile, decim, A)
    dev = consts.c2.device
    if dev.type == "cpu":
        return fm_chain_gen_warm_step_plain(g0, amp, consts, decim, gain,
                                            n_loc, warm, seed, draws, goff,
                                            ag, tile, nd)
    _check_kernel_shape(W, tile, A, L, ag, decim)
    amp = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    z1, zt = _zero_state(dev, A, W)
    _check_chain_tensors(dev, [("amp", amp, (1,))], z1, zt, consts)
    args = noise.stream_args(seed, draws)
    g = noise.device_group(g0, dev)
    aud = torch.empty((nd * (n_loc // decim), M), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_gen_warm_launch(
            g.data_ptr(), int(goff), nd, *args, amp.data_ptr(), z1.data_ptr(),
            zt.data_ptr(), consts.c2.data_ptr(), consts.fft.data_ptr(),
            consts.ataps.data_ptr(), aud.data_ptr(), n_loc, M, L, H8, A,
            int(decim), tile, ag, float(gain),
            ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_gen_warm_launch")
    fm_chain_gen_warm_step.launches += 1
    _count_bands(fm_chain_gen_warm_step, ag)
    return aud


fm_chain_gen_warm_step.launches = 0
fm_chain_gen_warm_step.ag2_launches = 0
fm_chain_gen_warm_step.ag4_launches = 0
