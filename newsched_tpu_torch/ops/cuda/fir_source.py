"""Config #0's live chain as ONE kernel (reference:
newsched_tpu/ops/pallas/fir_source.py ``fir_tone_step``): the fixed-point
NCO tone generated on the time-folded lanes and filtered by a real-tap FIR
(with decimation) in the same pass; the kernel is ``csrc/fir_source.cu``,
whose header says how it maps onto the H100.

Layout (the wideband-FM chain's time-folded lanes): a batch of 64*R
samples is R rows of 128 lanes, lane s = re and lane 64+s = im of segment
s, samples s*R .. s*R+R-1. The output is (R/D, 128) in the same layout
(``unfold_complex`` gives the cf32 stream). Sample k of segment s is the
tone of ``sources.nco_folded`` at batch index s*R + k: a negative index is
the previous batch's sample (the uint32 wrap) and, on the stream's first
batch, 0. So the chain is stateless but for the caller's phase counter and
first-batch flag, which the kernel reads from the card (the block keeps
them there, so a captured step replays with the state the step before
left); a time shard passes its index and starts 64*R*shard samples on.

Two kernel instances, picked by the tap count alone: up to ``FFT_MAX_TAPS``
(513) the overlap-save FFT convolution (``csrc/fir_source.cu``), past it,
up to ``PART_MAX_TAPS`` (32768), the same convolution with the taps cut
into partitions of ``PART_L`` = 512 (``csrc/fir_part.cu``); past that a
``ValueError`` names the limit. The reference has no limit but its window
(``W8 = _round8(ntaps - 1)`` rows in VMEM).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build
from newsched_tpu_torch.ops.cuda.mathfns import SINCOS_COEFFS
from newsched_tpu_torch.ops.cuda.sources import (folded_index, folded_values,
                                                 mask_before_stream, nco_args,
                                                 shard_phase)

S = 64  # fold width: segments = lane pairs
_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_THREADS = 256
RADICES = (8, 16, 32)  # Q: the kernel's transforms have N = Q*Q points
SEG_GROUP = 8  # segments per CUDA block
FFT_MAX_TAPS = RADICES[-1] ** 2 // 2 + 1  # 513: N = 1024 keeps L = 512 outputs
PART_Q = RADICES[-1]  # the partitioned instance's transforms: N = 1024
PART_L = PART_Q ** 2 // 2  # 512 outputs a transform, taps a partition
# 64 partitions: a 512 KB table of spectra, and P + 1 = 65 transforms an
# output block (~30x the work at 1024 taps)
PART_MAX_TAPS = 64 * PART_L
# segments per block of the partitioned instance: two rounds of 8 transforms
# a 512-row tile, so one round's tensor copies run while the next computes
# (chip_smoke.py phase 43 times it beside 8 and 32, PERF.md)
PART_SEG_GROUP = 16


def fft_radix(ntaps: int) -> int:
    """Q of the kernel's N = Q*Q-point transforms: the smallest power of two
    from 8 on with N/2 >= ntaps - 1 (each transform keeps L = N/2 outputs);
    past 32 no block's window fits in shared memory."""
    Q = 8
    while Q * Q // 2 < ntaps - 1:
        Q *= 2
    return Q


def fir_tone_table(taps, Q: int) -> np.ndarray:
    """The kernel's constants for N = Q*Q: (4, N) float32, rows 0/1 the
    real/imaginary parts of W_N^j = e^{-2 pi i j/N}, rows 2/3 those of the
    taps' N-point spectrum over N (the inverse transform's scale folded
    in); computed in float64 and rounded once."""
    N = Q * Q
    h = np.zeros(N)
    h[:len(taps)] = np.asarray(taps, np.float64)
    w = np.exp(-2j * np.pi * np.arange(N) / N)
    spec = np.fft.fft(h) / N
    return np.stack([w.real, w.imag, spec.real, spec.imag]).astype(np.float32)


class FirToneConsts(NamedTuple):
    """The chain's constants on one device: the taps (ntaps,) float32 and
    ``fft``, the kernel's twiddles and spectra (``fir_tone_table``, past
    ``FFT_MAX_TAPS`` ``fir_part_table``), which the CUDA wrapper
    requires."""

    taps: torch.Tensor
    fft: torch.Tensor | None


def part_count(ntaps: int) -> int:
    """P, the partitions of ``PART_L`` taps the partitioned instance cuts
    ``ntaps`` taps into."""
    return -(-int(ntaps) // PART_L)


def fir_part_table(taps) -> np.ndarray:
    """The partitioned instance's constants: (2 + 2P, N) float32 with N =
    1024, rows 0/1 the real/imaginary parts of W_N^j, rows 2 + 2p and 3 + 2p
    those of H_p / N, the N-point spectrum of taps [p*L, p*L + L) (L = 512)
    over N; computed in float64 and rounded once, as ``fir_tone_table``."""
    taps = np.asarray(taps, np.float64)
    N, L, P = PART_Q * PART_Q, PART_L, part_count(len(taps))
    h = np.zeros((P, N))  # partition p in row p, zero-padded
    for p in range(P):
        part = taps[p * L:(p + 1) * L]
        h[p, :len(part)] = part
    spec = np.fft.fft(h, axis=1) / N
    w = np.exp(-2j * np.pi * np.arange(N) / N)
    rows = [w.real, w.imag]
    for p in range(P):
        rows += [spec[p].real, spec[p].imag]
    return np.stack(rows).astype(np.float32)


def fir_tone_consts(taps, device) -> FirToneConsts:
    """The taps on ``device``, with the table of the instance the tap count
    takes: ``fir_tone_table`` up to ``FFT_MAX_TAPS``, ``fir_part_table``
    past it."""
    taps = np.asarray(taps, np.float32)
    tab = (fir_tone_table(taps, fft_radix(len(taps)))
           if len(taps) <= FFT_MAX_TAPS else fir_part_table(taps))
    return FirToneConsts(torch.as_tensor(taps, device=device),
                         torch.as_tensor(tab, device=device))


def pick_tile(R: int, D: int, L: int = 128, target: int = 512) -> int:
    """Batch rows per block: the largest multiple of D that divides R with
    at most ``target`` rows, a multiple of L too where R is (the
    transforms then align with the blocks: no block computes a transform
    it shares). At config #0's batch (R = 32768, D = 1) 512 rows and 8
    segments a block make 512 blocks, 4 transforms a segment, two blocks
    (99 KB of shared memory each) an SM: the fastest of the geometries
    chip_smoke.py times on the H100, the window's look-back 25% of its
    rows."""
    if R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    fits = [T for T in range(D, min(target, R) + 1, D) if R % T == 0] or [R]
    aligned = [T for T in fits if T % L == 0 and R % L == 0]
    return max(aligned or fits)


@functools.lru_cache(maxsize=None)
def window_stride(Q: int, GS: int) -> int:
    """The window's row stride in complex values: the smallest P >= GS for
    which a half-warp's loads (16 lanes = 16/Q transforms of consecutive
    segments, thread t reading row t + Q*n) hit the fewest 8-byte bank
    pairs twice."""
    lanes = np.arange(16)
    t, g = lanes % Q, lanes // Q

    def worst(P):
        return np.bincount((t * P + g) % 16, minlength=16).max()

    return min(range(GS, GS + 33), key=lambda P: (worst(P), P))


class _Geometry(NamedTuple):
    Q: int
    T: int
    GS: int
    NQ: int   # transforms a segment per block, at most
    off: int  # the window's first row, before the tile
    WR: int   # window rows
    PW: int
    BR: int   # > 0: output rows a round, written by a tensor copy
    smem: int


def _tile_rows(R: int, D: int, T: int, Q: int, GS: int, NQ: int) -> int:
    """Output rows of a round when a round's transforms fill whole rows of
    the block's tile (R and T multiples of L, every round G/GS transforms
    of each segment): the kernel then writes them as one box a plane by a
    tensor copy (at most 256 rows, 128-byte aligned); else 0, and 16-byte
    stores of 4 segments."""
    G, L = _THREADS // Q, Q * Q // 2
    if R % L or T % L or G % GS or NQ % (G // GS) or L % D:
        return 0
    BR = G // GS * L // D
    return BR if BR <= 256 and BR * GS * 4 % 128 == 0 else 0


@functools.lru_cache(maxsize=None)
def _geometry(R: int, D: int, ntaps: int, tile, GS: int) -> _Geometry:
    """The kernel's block geometry, computed once per shape (the wrapper
    runs every batch). Where R and T are multiples of L every block's
    transforms start at its tile; elsewhere a segment's first and last
    transforms reach past it and the window grows by their rows."""
    if D <= 0 or R <= 0 or R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    Q = fft_radix(ntaps)
    N, L = Q * Q, Q * Q // 2
    T = int(tile) if tile else pick_tile(R, D, L)
    if T <= 0 or R % T or T % D:
        raise ValueError(f"tile {T} incompatible with R={R}, D={D}")
    if GS < 8 or S % GS:
        raise ValueError(f"seg_group {GS}: the kernel takes 8, 16, 32 or 64 "
                         f"segments a block")
    if R % L == 0 and T % L == 0:
        NQ, off, WR = T // L, L, T + L
    else:
        NQ, off, WR = (T + L - 2) // L + 1, N - 1, T + 3 * L - 2
    PW = window_stride(Q, GS)
    BR = _tile_rows(R, D, T, Q, GS, NQ)
    smem = (-(-BR * GS // 16) * 16 + WR * PW
            + _THREADS // Q * (Q * (Q + 1) + 1) + Q * Q + N + -(-GS // 2)) * 8
    if smem > _SMEM_MAX:
        raise ValueError(f"tile {T}, decim {D}, {ntaps} taps: {smem} bytes of "
                         f"shared memory, the H100 allows {_SMEM_MAX}")
    if Q not in RADICES:  # no window of N >= 4096 fits: the check above
        raise ValueError(f"{ntaps} taps: no radix for N = {N}")
    return _Geometry(Q, T, GS, NQ, off, WR, PW, BR, smem)


class _Part(NamedTuple):
    """The partitioned instance's block geometry (csrc/fir_part.cu)."""

    T: int
    GS: int
    NQ: int  # output blocks a segment per block, at most
    P: int   # partitions of the taps
    BR: int  # > 0: output rows a round (L / D), written by tensor copies
    smem: int


@functools.lru_cache(maxsize=None)
def _part_geometry(R: int, D: int, ntaps: int, tile, GS: int) -> _Part:
    """The partitioned instance's geometry: tiles as ``pick_tile`` picks
    them at L = 512 (512 rows, one output block a segment, at config #0's
    batch), 8 transforms a round, GS / 8 rounds an output block; where R
    and T are multiples of L, each round's rows written by tensor copies
    (``BR``). Its shared memory (the round's tile, the exchange buffers,
    the spectra's sums, the twiddles: ~174 KB at D = 1) does not depend on
    the taps."""
    if D <= 0 or R <= 0 or R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    if ntaps > PART_MAX_TAPS:
        raise ValueError(
            f"{ntaps} taps: K9 takes at most {PART_MAX_TAPS} taps "
            f"({PART_MAX_TAPS // PART_L} partitions of {PART_L}); the "
            f"reference's limit is its window")
    L = PART_L
    T = int(tile) if tile else pick_tile(R, D, L)
    if T <= 0 or R % T or T % D:
        raise ValueError(f"tile {T} incompatible with R={R}, D={D}")
    if GS < 8 or S % GS:
        raise ValueError(f"seg_group {GS}: the kernel takes 8, 16, 32 or 64 "
                         f"segments a block")
    aligned = R % L == 0 and T % L == 0
    NQ = T // L if aligned else (T + L - 2) // L + 1
    BR = L // D if aligned and L % D == 0 else 0
    G, N = _THREADS // PART_Q, PART_Q * PART_Q
    smem = (G * BR + G * (PART_Q * (PART_Q + 1) + 1) + G * N + PART_Q ** 2
            + -(-GS // 2)) * 8
    return _Part(T, GS, NQ, part_count(ntaps), BR, smem)


def plan(R: int, D: int, ntaps: int, tile=None, seg_group: int | None = None):
    """The instance K9 launches for these taps and its geometry: the FFT
    convolution's ``_Geometry`` up to ``FFT_MAX_TAPS`` taps, else the
    partitioned instance's ``_Part`` up to ``PART_MAX_TAPS``
    (``seg_group`` None: ``SEG_GROUP``, ``PART_SEG_GROUP``). Raises past
    that, or where the geometry does not fit."""
    if ntaps <= FFT_MAX_TAPS:
        return _geometry(R, D, ntaps, tile, seg_group or SEG_GROUP)
    return _part_geometry(R, D, ntaps, tile, seg_group or PART_SEG_GROUP)


def fir_tone_step_plain(phase0, dphase, amp, first, taps, decim: int, R: int,
                        shard: int = 0):
    """The plain PyTorch version of ``fir_tone_step`` (``taps``: the taps,
    or ``FirToneConsts``): the folded tone (``sources.folded_values``) over
    rows [-(ntaps-1), R), zero before the stream on the first batch, then
    the FIR tap by tap, in direct form."""
    if isinstance(taps, FirToneConsts):
        taps = taps.taps
    R, D = int(R), int(decim)
    nt = int(taps.shape[0])
    W = nt - 1
    idx = folded_index(R, -W, W + R, taps.device)
    x = folded_values(shard_phase(phase0, dphase, shard, R), dphase, amp, idx)
    x = mask_before_stream(x, idx, first, shard)
    n_o = R // D
    out = torch.zeros((n_o, 2 * S), dtype=torch.float32, device=taps.device)
    for t in range(nt):
        lo = W - t
        out = out + taps[t] * x[lo:lo + (n_o - 1) * D + 1:D]
    return out


def fir_tone_step(phase0, dphase, amp, first, taps, decim: int, R: int,
                  tile: int | None = None, shard: int = 0):
    """One batch of the live filtered tone: R folded rows (64*R samples)
    generated from the phase counter and filtered (and decimated) in one
    pass.

    Args:
      phase0, dphase: the NCO's phase at the batch's first sample and its
        increment (uint32 values: int64 tensors on the device, the block's
        state and parameter, or host ints).
      amp: float32 scalar amplitude (a 0-dim tensor or a number).
      first: the stream's first batch (the samples before it are 0): a
        bool tensor on the device, or a bool.
      taps: ``fir_tone_consts(taps, device)`` on the device to run on, or
        on the CPU the (ntaps,) float32 real taps alone.
      decim: the FIR's decimation D (R % D == 0).
      R: folded rows of the batch.
      tile: batch rows per CUDA block, a multiple of D dividing R (None:
        ``pick_tile``). It does not change the outputs, bit for bit.
      shard: the time shard of the batch this call computes (R rows of
        it, from 64*R*shard samples on; only shard 0 reads ``first``).

    Returns (R/D, 128) float32 folded planes of the filtered stream. Both
    instances are FFT convolutions that align their transforms to the
    batch index at multiples of L (``fft_radix``: L = 128 at up to 129
    taps; L = ``PART_L`` = 512 past ``FFT_MAX_TAPS``), so the output is
    bit-identical for every tile and segment group, and for every batch
    split and time shard whose boundaries fall on multiples of L. Any R is
    taken.

    CPU tensors (``taps`` on the CPU) take the plain version; on a CUDA
    device it launches ``fir_tone_launch`` (csrc/fir_source.cu, K9) or,
    past ``FFT_MAX_TAPS`` taps, ``fir_part_launch`` (csrc/fir_part.cu,
    counted on ``fir_tone_step.partitioned_launches``).
    """
    R, D = int(R), int(decim)
    consts = taps if isinstance(taps, FirToneConsts) else FirToneConsts(taps,
                                                                        None)
    g = plan(R, D, int(consts.taps.shape[0]), tile)
    if consts.taps.device.type == "cpu":
        return fir_tone_step_plain(phase0, dphase, amp, first, consts.taps, D,
                                   R, shard)
    return _launch(phase0, dphase, amp, first, consts, D, R, g, shard)


def _launch(phase0, dphase, amp, first, consts: FirToneConsts, D: int, R: int,
            g, shard: int = 0):
    """Launch the instance of ``g``: the FFT instance for a ``_Geometry``,
    the partitioned one for a ``_Part``."""
    dev = consts.taps.device
    if consts.fft is None:
        raise ValueError("taps: the kernel takes the FIR as an FFT "
                         "convolution and needs its twiddle table; pass "
                         "fir_tone_consts(taps, device)")
    part = isinstance(g, _Part)
    N = PART_Q * PART_Q if part else g.Q * g.Q
    _build.check_tensor(consts.fft, "fft", device=dev,
                        shape=(2 + 2 * g.P if part else 4, N))
    a = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    ph, dp = nco_args(phase0, dphase, dev)
    fl = _build.device_scalar(first, "first", device=dev, dtype=torch.bool)
    out = torch.empty((R // D, 2 * S), dtype=torch.float32, device=dev)
    coeffs = SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p)
    if part:
        with torch.cuda.device(dev):
            err = _build.lib().fir_part_launch(
                ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
                int(shard), consts.fft.data_ptr(), out.data_ptr(), R, D, g.T,
                g.GS, g.NQ, g.P, g.BR, coeffs,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "fir_part_launch")
        fir_tone_step.partitioned_launches += 1
        return out
    with torch.cuda.device(dev):
        err = _build.lib().fir_tone_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
            int(shard), consts.fft.data_ptr(), out.data_ptr(), R, g.Q, D,
            g.T, g.GS, g.NQ, g.off, g.WR, g.PW, g.BR, coeffs,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fir_tone_launch")
    fir_tone_step.launches += 1
    return out


fir_tone_step.launches = 0
fir_tone_step.partitioned_launches = 0


def unfold_complex(planes: torch.Tensor) -> torch.Tensor:
    """(R, 128) folded planes -> (64*R,) complex64 in stream order."""
    return torch.complex(planes[:, :S].T.reshape(-1), planes[:, S:].T.reshape(-1))
