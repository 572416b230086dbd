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
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
_J = 9  # consecutive outputs a CUDA thread computes (kJ)
SEG_GROUP = 4  # segments per CUDA block


def pick_tile(R: int, D: int, target_out: int = 512) -> int:
    """Batch rows per block: the largest multiple of D that divides R with
    at most ``target_out`` output rows. At config #0's batch (R = 32768,
    D = 1) 512 rows and 4 segments a block make 1024 blocks of one chunk
    each."""
    if R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    n_o = R // D
    return D * max(t for t in range(1, min(target_out, n_o) + 1) if n_o % t == 0)


class _Geometry(NamedTuple):
    T: int
    GS: int
    P: int
    CU: int
    smem: int


@functools.lru_cache(maxsize=None)
def _geometry(R: int, D: int, ntaps: int, tile, GS: int) -> _Geometry:
    """The kernel's block geometry, computed once per shape (the wrapper
    runs every batch)."""
    if D <= 0 or R <= 0 or R % D:
        raise ValueError(f"batch fold R={R} not a multiple of decim {D}")
    T = int(tile) if tile else pick_tile(R, D)
    if T <= 0 or R % T or T % D:
        raise ValueError(f"tile {T} incompatible with R={R}, D={D}")
    if GS <= 0 or S % GS:
        raise ValueError(f"seg_group {GS} does not divide {S} segments")
    P = row_stride(GS, _J * D)
    CU = _THREADS // GS * _J
    cu = min(T // D, CU)
    rows = (-(-cu // _J) * _J - 1) * D + ntaps
    smem = (ntaps + 2 * rows * P) * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"tile {T}, decim {D}, {ntaps} taps: {smem} bytes of "
                         f"shared memory, the H100 allows {_SMEM_MAX}")
    return _Geometry(T, GS, P, CU, smem)


def fir_tone_step_plain(phase0, dphase, amp, first, taps: torch.Tensor,
                        decim: int, R: int, shard: int = 0):
    """The plain PyTorch version of ``fir_tone_step``: the folded tone
    (``sources.folded_values``) over rows [-(ntaps-1), R), zero before the
    stream on the first batch, then the FIR tap by tap."""
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


def fir_tone_step(phase0, dphase, amp, first, taps: torch.Tensor,
                  decim: int, R: int, tile: int | None = None, shard: int = 0):
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
      taps: (ntaps,) float32 real taps on the device to run on.
      decim: the FIR's decimation D (R % D == 0).
      R: folded rows of the batch.
      tile: batch rows per CUDA block, a multiple of D dividing R (None:
        ``pick_tile``). It does not change the outputs, bit for bit.
      shard: the time shard of the batch this call computes (R rows of
        it, from 64*R*shard samples on; only shard 0 reads ``first``).

    Returns (R/D, 128) float32 folded planes of the filtered stream.

    CPU tensors (``taps`` on the CPU) take the plain version; on a CUDA
    device it launches ``fir_tone_launch`` (csrc/fir_source.cu, K9).
    """
    R, D = int(R), int(decim)
    g = _geometry(R, D, int(taps.shape[0]), tile, SEG_GROUP)
    if taps.device.type == "cpu":
        return fir_tone_step_plain(phase0, dphase, amp, first, taps, D, R,
                                   shard)
    return _launch(phase0, dphase, amp, first, taps, D, R, g, shard)


def _launch(phase0, dphase, amp, first, taps, D: int, R: int, g: _Geometry,
            shard: int = 0):
    dev = taps.device
    _build.check_tensor(taps, "taps", device=dev, shape=(int(taps.shape[0]),))
    a = torch.as_tensor(amp, dtype=torch.float32, device=dev).reshape(1)
    ph, dp = nco_args(phase0, dphase, dev)
    fl = _build.device_scalar(first, "first", device=dev, dtype=torch.bool)
    out = torch.empty((R // D, 2 * S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fir_tone_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), fl.data_ptr(),
            int(shard), taps.data_ptr(), out.data_ptr(), R,
            int(taps.shape[0]), D, g.T, g.GS, g.P, g.CU,
            SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fir_tone_launch")
    fir_tone_step.launches += 1
    return out


fir_tone_step.launches = 0


def unfold_complex(planes: torch.Tensor) -> torch.Tensor:
    """(R, 128) folded planes -> (64*R,) complex64 in stream order."""
    return torch.complex(planes[:, :S].T.reshape(-1), planes[:, S:].T.reshape(-1))
