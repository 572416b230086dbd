"""The wideband-FM receive chain as ONE kernel (reference:
newsched_tpu/ops/pallas/wbfm_chain.py ``wbfm_chain_step``, and
``wbfm_chain_live_step``, the same chain with its input generated inside).

Fuses BASELINE config #1 (freq_xlating_fir -> quadrature_demod ->
rational_resampler) into one pass over the batch; the kernel is
``csrc/wbfm_chain.cu``, whose header says how it maps onto the H100.

Layout (the reference's time-folded lanes): a batch of n = 64*R complex
samples folds into 64 segments of R consecutive samples, as an (R, 128)
float32 matrix with lane s = re(segment s), lane 64+s = im. Audio comes
back as (R / (D*Rd), 128) with each segment's value in both halves
(``unfold_audio`` gives the scalar stream).

The xlate's output NCO folds through the demod: with the taps rotated by
the xlate frequency w, c_rot[t] = c[t] e^{j w t}, the demod product of the
rotated-taps output is the staged chain's times a CONSTANT e^{-j w D}, so
the NCO disappears (an exact identity). The only cross-batch state is the
batch's last B8 raw rows (``carry``), from which every block rebuilds the
demod's previous sample and the resampler's A-1-row tail.

Precision: FP32 throughout and the degree-9 atan2 for every value of
``precision`` (the reference's tiers exist because its matrix unit works
in bf16 passes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build
from newsched_tpu_torch.ops.cuda.mathfns import (ATAN_COEFFS, SINCOS_COEFFS,
                                                 atan2_plain)
from newsched_tpu_torch.ops.cuda.sources import (folded_index, folded_values,
                                                 mask_before_stream, nco_args,
                                                 shard_phase)

S = 64  # fold width: segments = lane pairs
_M32 = 0xFFFFFFFF
_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use
_J = 7  # consecutive xlate outputs a CUDA thread computes (kJ)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class WbfmChainPlan:
    """The chain's host constants and geometry for one configuration:
    rotated channel taps, the demod's constant rotation, resampler taps,
    and the junction sizes (W8: the xlate's lookback rounded to 8; B8: the
    raw rows a block reaches back for its junction)."""

    def __init__(self, chan_taps, dphase: int, decim: int, resamp_taps,
                 resamp_decim: int, demod_gain: float, precision="split3"):
        self.D = int(decim)
        self.Rd = int(resamp_decim)
        self.resamp_taps = np.asarray(resamp_taps, np.float32)
        self.A = int(len(resamp_taps))
        self.precision = precision
        self.gain = float(demod_gain)
        self.ntaps = int(len(chan_taps))
        self.W8 = _round8(self.ntaps - 1)
        # the A-1 tail rows and the demod's previous sample, with the
        # zero-history first demod kept out of the tail
        self.warm_out = self.A + 1
        self.B8 = _round8(self.warm_out * self.D + self.ntaps - 1)
        w = 2 * np.pi * (int(dphase) & _M32) / (1 << 32)
        self.cos_t = float(np.cos(w * self.D))
        self.sin_t = float(np.sin(w * self.D))
        self.c_rot = (np.asarray(chan_taps, np.float64)
                      * np.exp(1j * w * np.arange(self.ntaps)))


class WbfmConsts(NamedTuple):
    """A plan's constants on one device: rotated taps as (ntaps, 2) [re, im]
    float32 and the resampler taps (A,)."""

    crot: torch.Tensor
    rtaps: torch.Tensor


def wbfm_consts(plan: WbfmChainPlan, device) -> WbfmConsts:
    c = np.stack([plan.c_rot.real, plan.c_rot.imag], axis=1)
    return WbfmConsts(
        torch.as_tensor(np.ascontiguousarray(c, np.float32), device=device),
        torch.as_tensor(plan.resamp_taps, device=device))


def fold_planes(x: torch.Tensor) -> torch.Tensor:
    """(n,) complex batch -> (n/64, 128) time-folded planes."""
    n = int(x.shape[0])
    Xc = x.reshape(S, n // S).T
    return torch.cat([Xc.real, Xc.imag], dim=1).to(torch.float32).contiguous()


def unfold_audio(aud: torch.Tensor) -> torch.Tensor:
    """(R_a, 128) duplicated-halves audio -> (R_a * 64,) in stream order."""
    return aud[:, :S].T.reshape(-1)


def pick_tile(R: int, D: int, Rd: int, target_out: int = 102) -> int:
    """Batch rows per block: the largest multiple of D*Rd that divides R
    with at most ``target_out`` audio rows. The junction costs each block
    A+1 extra xlate outputs, so larger tiles waste less, and smaller tiles
    give more blocks. At config #1's batch (R = 32640) 102 rows with 8
    segments a block make 128 blocks, one wave of one 512-thread block an
    SM on the H100's 132 SMs, the junction +24% xlate outputs; 51 rows
    (256 blocks, +48%) ran 21% longer, and 4 segments a block (256 blocks
    of 256 threads, two an SM, half-sector rows) 11% longer."""
    step = D * Rd
    if R % step:
        raise ValueError(f"batch fold R={R} not a multiple of D*Rd = {step}")
    n_o = R // step
    return step * max(t for t in range(1, min(target_out, n_o) + 1)
                      if n_o % t == 0)


@functools.lru_cache(maxsize=None)
def row_stride(GS: int, rows: int) -> int:
    """Shared row stride of the sample planes: the smallest P >= GS for
    which a warp's reads (lane -> segment lane % GS, window lane // GS,
    windows ``rows`` rows apart) hit the fewest banks twice."""
    lanes = np.arange(32)

    def worst(P):
        banks = ((lanes // GS) * rows * P + lanes % GS) % 32
        return np.bincount(banks, minlength=32).max()

    return min(range(GS, GS + 33), key=lambda P: (worst(P), P))


def block_threads(GS: int) -> int:
    """Threads a block: 512 from 8 segments a block on (one block an SM at
    config #1), else 256 (two blocks an SM)."""
    return 512 if GS >= 8 else 256


class _Geometry(NamedTuple):
    T: int
    GS: int
    P: int
    NT: int
    CU: int
    smem: int


def _geometry(plan: WbfmChainPlan, R: int, tile, seg_group: int) -> _Geometry:
    return _geometry_of(plan.D, plan.Rd, plan.A, plan.ntaps, plan.B8, int(R),
                        tile, int(seg_group))


@functools.lru_cache(maxsize=None)
def _geometry_of(D: int, Rd: int, A: int, ntaps: int, B8: int, R: int, tile,
                 GS: int) -> _Geometry:
    """The kernels' block geometry, computed once per shape (the wrappers
    run every batch)."""
    T = int(tile) if tile else pick_tile(R, D, Rd)
    if T <= 0 or R % T or T % (D * Rd):
        raise ValueError(f"tile {T} incompatible with R={R}, D={D}, Rd={Rd}")
    if R < B8:
        raise ValueError(
            f"batch fold R={R} rows < boundary {B8} rows — increase "
            f"the batch (need >= {B8 * S} samples)")
    if GS <= 0 or S % GS:
        raise ValueError(f"seg_group {GS} does not divide {S} segments")
    P = row_stride(GS, _J * D)
    NT = block_threads(GS)
    CU = NT // GS * _J
    NU = (T // (D * Rd) - 1) * Rd + A + 1
    floats = (_round4(2 * ntaps) + _round4(A)
              + 2 * _round4(((CU - 1) * D + ntaps) * P) + 3 * NU * GS)
    if floats * 4 > _SMEM_MAX:
        raise ValueError(f"tile {T}, seg_group {GS}: {floats * 4} bytes of "
                         f"shared memory, the H100 allows {_SMEM_MAX}")
    return _Geometry(T, GS, P, NT, CU, floats * 4)


def _extended(xp: torch.Tensor, carry: torch.Tensor, B8: int):
    """(B8 + R, 64) re and im of every segment's samples from B8 before
    the batch: the previous segment's last rows, for segment 0 the carry's
    last segment."""
    R = int(xp.shape[0])
    bot = xp[R - B8:]

    def plane(lo):
        prev = torch.cat([carry[:, lo + S - 1:lo + S], bot[:, lo:lo + S - 1]], 1)
        return torch.cat([prev, xp[:, lo:lo + S]])

    return plane(0), plane(S)


def _chain_plain(xr: torch.Tensor, xi: torch.Tensor, plan: WbfmChainPlan,
                 consts: WbfmConsts, R: int) -> torch.Tensor:
    """The chain over extended sample planes (B8 + R, 64): the audio
    (R/(D*Rd), 128)."""
    D, Rd, A, B8, nt = plan.D, plan.Rd, plan.A, plan.B8, plan.ntaps
    NU = R // D + A  # U[m] for m in [-A, R/D)
    ur = torch.zeros((NU, S), dtype=torch.float32, device=xr.device)
    ui = torch.zeros_like(ur)
    for t in range(nt):
        lo = B8 - A * D - t
        sr, si = xr[lo:lo + (NU - 1) * D + 1:D], xi[lo:lo + (NU - 1) * D + 1:D]
        cr, ci = consts.crot[t, 0], consts.crot[t, 1]
        ur = ur + cr * sr - ci * si
        ui = ui + cr * si + ci * sr
    ar, ai, yr, yi = ur[:-1], ui[:-1], ur[1:], ui[1:]
    pr0 = ar * yr + ai * yi
    pi0 = ar * yi - ai * yr
    c, s = np.float32(plan.cos_t), np.float32(plan.sin_t)
    pr = float(c) * pr0 + float(s) * pi0
    pi = float(c) * pi0 - float(s) * pr0
    d = atan2_plain(pi, pr) * np.float32(plan.gain)  # d[m], m in [-A+1, R/D)
    n_o = R // (D * Rd)
    out = torch.zeros((n_o, S), dtype=torch.float32, device=xr.device)
    for k in range(A):
        j = A - 1 - k
        out = out + consts.rtaps[k] * d[j:j + (n_o - 1) * Rd + 1:Rd]
    return torch.cat([out, out], dim=1)


def wbfm_chain_step_plain(xp: torch.Tensor, carry: torch.Tensor,
                          plan: WbfmChainPlan, consts: WbfmConsts):
    """The plain PyTorch version of ``wbfm_chain_step``."""
    R = int(xp.shape[0])
    xr, xi = _extended(xp, carry, plan.B8)
    return _chain_plain(xr, xi, plan, consts, R), xp[R - plan.B8:].clone()


def _check(plan: WbfmChainPlan, consts: WbfmConsts, dev) -> None:
    _build.check_tensor(consts.crot, "crot", device=dev, shape=(plan.ntaps, 2))
    _build.check_tensor(consts.rtaps, "rtaps", device=dev, shape=(plan.A,))


def _launch_args(plan: WbfmChainPlan, consts: WbfmConsts, aud, R: int,
                 g: _Geometry):
    return (consts.crot.data_ptr(), consts.rtaps.data_ptr(), aud.data_ptr(),
            R, plan.ntaps, plan.D, plan.Rd, plan.A, plan.B8, g.T, g.GS, g.P,
            g.NT, g.CU, float(np.float32(plan.cos_t)),
            float(np.float32(plan.sin_t)),
            float(np.float32(plan.gain)),
            ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p))


def wbfm_chain_step(xp: torch.Tensor, carry: torch.Tensor,
                    plan: WbfmChainPlan, consts: WbfmConsts,
                    tile: int | None = None, seg_group: int = 8):
    """One batch of the fused chain.

    Args:
      xp: (R, 128) float32 folded planes of this batch.
      carry: (B8, 128) the previous batch's last B8 rows (zeros at stream
        start).
      plan, consts: ``WbfmChainPlan`` and ``wbfm_consts(plan, device)``.
      tile: batch rows per CUDA block, a multiple of D*Rd dividing R (None:
        ``pick_tile``); seg_group: segments per block, a divisor of 64.
        Neither changes the outputs, bit for bit.

    Returns (audio (R/(D*Rd), 128), new carry (B8, 128)).

    CPU tensors take the plain version; CUDA tensors launch
    ``wbfm_chain_launch`` (csrc/wbfm_chain.cu, kernel K10).
    """
    R = int(xp.shape[0])
    g = _geometry(plan, R, tile, seg_group)
    if tuple(carry.shape) != (plan.B8, 2 * S):
        raise ValueError(f"carry shape {tuple(carry.shape)} != "
                         f"({plan.B8}, {2 * S})")
    dev = xp.device
    if dev.type == "cpu":
        return wbfm_chain_step_plain(xp, carry, plan, consts)
    _build.check_tensor(xp, "xp", device=dev, shape=(R, 2 * S))
    _build.check_tensor(carry, "carry", device=dev)
    _check(plan, consts, dev)
    aud = torch.empty((R // (plan.D * plan.Rd), 2 * S), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().wbfm_chain_launch(
            xp.data_ptr(), carry.data_ptr(),
            *_launch_args(plan, consts, aud, R, g),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wbfm_chain_launch")
    wbfm_chain_step.launches += 1
    return aud, xp[R - plan.B8:].clone()


wbfm_chain_step.launches = 0


def wbfm_chain_live_step_plain(phase0, dphase, amp, first,
                               plan: WbfmChainPlan, consts: WbfmConsts,
                               R: int, shard: int = 0):
    """The plain PyTorch version of ``wbfm_chain_live_step``: the folded
    tone (``sources.folded_values``) over the same extended rows, zero
    before the stream on the first batch."""
    dev = consts.crot.device
    idx = folded_index(R, -plan.B8, plan.B8 + int(R), dev)
    x = folded_values(shard_phase(phase0, dphase, shard, R), dphase, amp, idx)
    x = mask_before_stream(x, idx, first, shard)
    return _chain_plain(x[:, :S], x[:, S:], plan, consts, int(R))


def wbfm_chain_live_step(phase0, dphase, amp, first, plan: WbfmChainPlan,
                         consts: WbfmConsts, R: int, tile: int | None = None,
                         seg_group: int = 8, shard: int = 0):
    """One batch of the LIVE chain: the NCO tone of ``sources.nco_folded``
    generated inside the chain. ``phase0``/``dphase``: the batch's phase
    and increment, int64 tensors on the device (the block's state and
    parameter, read by the kernel from the card) or host ints; amp: a
    float32 scalar. ``first`` (a bool tensor on the device, or a bool)
    marks the stream's first batch, before which the samples are 0.
    ``shard``: the time shard of the batch this call computes, R rows of
    it, at 64*R*shard samples from the phase (only shard 0 reads
    ``first``). Returns audio (R/(D*Rd), 128), bit for bit what
    ``nco_folded`` -> ``wbfm_chain_step`` gives at the same tile and
    segment group.

    CPU tensors (``consts`` on the CPU) take the plain version; on a CUDA
    device it launches ``wbfm_live_launch`` (csrc/wbfm_chain.cu, K12).
    """
    R = int(R)
    g = _geometry(plan, R, tile, seg_group)
    dev = consts.crot.device
    if dev.type == "cpu":
        return wbfm_chain_live_step_plain(phase0, dphase, amp, first, plan,
                                          consts, R, shard)
    _check(plan, consts, dev)
    a = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    ph, dp = nco_args(phase0, dphase, dev)
    fl = _build.device_scalar(first, "first", device=dev, dtype=torch.bool)
    aud = torch.empty((R // (plan.D * plan.Rd), 2 * S), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().wbfm_live_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
            int(shard),
            *_launch_args(plan, consts, aud, R, g),
            SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wbfm_live_launch")
    wbfm_chain_live_step.launches += 1
    return aud


wbfm_chain_live_step.launches = 0
