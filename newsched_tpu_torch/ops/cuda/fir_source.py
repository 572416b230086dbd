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
(513) the overlap-save FFT convolution (``csrc/fir_source.cu``), past it
the direct form (``csrc/fir_direct.cu``), whose window takes ~36 bytes of
shared memory a tap; a tap count that fits neither raises, naming the
largest the shape takes (``direct_max_taps``).
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
from newsched_tpu_torch.ops.cuda.wbfm_chain import row_stride

S = 64  # fold width: segments = lane pairs
_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_THREADS = 256
RADICES = (8, 16, 32)  # Q: the kernel's transforms have N = Q*Q points
SEG_GROUP = 8  # segments per CUDA block
FFT_MAX_TAPS = RADICES[-1] ** 2 // 2 + 1  # 513: N = 1024 keeps L = 512 outputs
_J = 9  # consecutive outputs a thread of the direct instance computes (kJ)
DIRECT_SEG_GROUP = 4  # segments per block of the direct instance


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
    ``fft``, the kernel's twiddles and spectrum (``fir_tone_table``), which
    the CUDA wrapper requires."""

    taps: torch.Tensor
    fft: torch.Tensor | None


def fir_tone_consts(taps, device) -> FirToneConsts:
    """The taps on ``device``, with the FFT instance's table where the tap
    count takes it (None past ``FFT_MAX_TAPS``: the direct instance reads
    the taps alone)."""
    taps = np.asarray(taps, np.float32)
    tab = (torch.as_tensor(fir_tone_table(taps, fft_radix(len(taps))),
                           device=device)
           if len(taps) <= FFT_MAX_TAPS else None)
    return FirToneConsts(torch.as_tensor(taps, device=device), tab)


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


class _Direct(NamedTuple):
    """The direct instance's block geometry (csrc/fir_direct.cu)."""

    T: int
    GS: int
    P: int   # shared row stride of the sample planes
    CU: int  # outputs a chunk
    smem: int


def pick_direct_tile(R: int, D: int, target_out: int = 512) -> int:
    """The direct instance's batch rows per block: the largest multiple of
    D that divides R with at most ``target_out`` output rows."""
    if R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    n_o = R // D
    return D * max(t for t in range(1, min(target_out, n_o) + 1)
                   if n_o % t == 0)


def _direct_smem(ntaps: int, D: int, T: int, GS: int) -> tuple[int, int, int]:
    """(P, CU, shared bytes) of a direct-instance block: the taps, then the
    re and im planes of the chunk's window, its look-back included."""
    P = row_stride(GS, _J * D)
    CU = _THREADS // GS * _J
    rows = (-(-min(T // D, CU) // _J) * _J - 1) * D + ntaps
    return P, CU, (ntaps + 2 * rows * P) * 4


def direct_max_taps(D: int, T: int, GS: int = DIRECT_SEG_GROUP) -> int:
    """The largest tap count whose window fits a direct-instance block at
    decimation D and T batch rows a block (6001 at D = 1, T = 512)."""
    P, _, base = _direct_smem(0, D, T, GS)
    return (_SMEM_MAX - base) // (4 * (1 + 2 * P))


@functools.lru_cache(maxsize=None)
def _direct_geometry(R: int, D: int, ntaps: int, tile,
                     GS: int = DIRECT_SEG_GROUP) -> _Direct:
    if D <= 0 or R <= 0 or R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    T = int(tile) if tile else pick_direct_tile(R, D)
    if T <= 0 or R % T or T % D:
        raise ValueError(f"tile {T} incompatible with R={R}, D={D}")
    if GS <= 0 or S % GS or GS & (GS - 1):
        raise ValueError(f"seg_group {GS}: a power of 2 dividing {S}")
    P, CU, smem = _direct_smem(ntaps, D, T, GS)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"{ntaps} taps: K9 takes at most {direct_max_taps(D, T, GS)} taps "
            f"at decim {D} and tile {T} ({smem} bytes of shared memory, the "
            f"H100 allows {_SMEM_MAX}); the reference's limit is its window")
    return _Direct(T, GS, P, CU, smem)


def plan(R: int, D: int, ntaps: int, tile=None):
    """The instance K9 launches for these taps and its geometry: the FFT
    convolution's ``_Geometry`` up to ``FFT_MAX_TAPS`` taps, else the
    direct form's ``_Direct``. Raises where neither fits."""
    if ntaps <= FFT_MAX_TAPS:
        return _geometry(R, D, ntaps, tile, SEG_GROUP)
    return _direct_geometry(R, D, ntaps, tile)


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

    Returns (R/D, 128) float32 folded planes of the filtered stream. Up
    to ``FFT_MAX_TAPS`` taps the kernel is an FFT convolution that aligns
    its transforms to the batch index at multiples of L (``fft_radix``: L
    = 128 at up to 129 taps), so its output is bit-identical for every
    batch split and time shard whose boundaries fall on multiples of L;
    past it the direct form, bit-identical for every tile, split and
    shard (its outputs depend only on the samples). Any R is taken.

    CPU tensors (``taps`` on the CPU) take the plain version; on a CUDA
    device it launches ``fir_tone_launch`` (csrc/fir_source.cu, K9) or,
    past ``FFT_MAX_TAPS`` taps, ``fir_direct_launch`` (csrc/fir_direct.cu).
    """
    R, D = int(R), int(decim)
    consts = taps if isinstance(taps, FirToneConsts) else FirToneConsts(taps,
                                                                        None)
    g = plan(R, D, int(consts.taps.shape[0]), tile)
    if consts.taps.device.type == "cpu":
        return fir_tone_step_plain(phase0, dphase, amp, first, consts.taps, D,
                                   R, shard)
    if isinstance(g, _Direct):
        return _launch_direct(phase0, dphase, amp, first, consts, D, R, g,
                              shard)
    return _launch(phase0, dphase, amp, first, consts, D, R, g, shard)


def _launch(phase0, dphase, amp, first, consts: FirToneConsts, D: int, R: int,
            g: _Geometry, shard: int = 0):
    dev = consts.taps.device
    if consts.fft is None:
        raise ValueError("taps: the kernel takes the FIR as an FFT "
                         "convolution and needs its twiddle table; pass "
                         "fir_tone_consts(taps, device)")
    _build.check_tensor(consts.fft, "fft", device=dev,
                        shape=(4, g.Q * g.Q))
    a = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    ph, dp = nco_args(phase0, dphase, dev)
    fl = _build.device_scalar(first, "first", device=dev, dtype=torch.bool)
    out = torch.empty((R // D, 2 * S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fir_tone_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
            int(shard), consts.fft.data_ptr(), out.data_ptr(), R, g.Q, D,
            g.T, g.GS, g.NQ, g.off, g.WR, g.PW, g.BR,
            SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fir_tone_launch")
    fir_tone_step.launches += 1
    return out


fir_tone_step.launches = 0


def _launch_direct(phase0, dphase, amp, first, consts: FirToneConsts, D: int,
                   R: int, g: _Direct, shard: int = 0):
    """Launch the direct instance (counted on ``direct_launches``)."""
    dev = consts.taps.device
    nt = int(consts.taps.shape[0])
    _build.check_tensor(consts.taps, "taps", device=dev, shape=(nt,))
    a = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    ph, dp = nco_args(phase0, dphase, dev)
    fl = _build.device_scalar(first, "first", device=dev, dtype=torch.bool)
    out = torch.empty((R // D, 2 * S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fir_direct_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
            int(shard), consts.taps.data_ptr(), out.data_ptr(), R, nt, D, g.T,
            g.GS, g.P, g.CU, SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fir_direct_launch")
    fir_tone_step.direct_launches += 1
    return out


fir_tone_step.direct_launches = 0


def unfold_complex(planes: torch.Tensor) -> torch.Tensor:
    """(R, 128) folded planes -> (64*R,) complex64 in stream order."""
    return torch.complex(planes[:, :S].T.reshape(-1), planes[:, S:].T.reshape(-1))
