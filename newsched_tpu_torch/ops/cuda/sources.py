"""The fixed-point NCO tone sources (reference:
newsched_tpu/ops/pallas/sources.py ``nco_planes`` and ``nco_folded``).

Sample k of a batch is amp * e^{j 2 pi acc(k) / 2^32} with
acc(k) = phase0 + k * dphase mod 2^32, the exact fixed-point accumulator of
ops/nco.py. As in the reference's kernels, the accumulator is read as a
SIGNED int32, converted to float32 and scaled by 2^-32 (turns in
[-0.5, 0.5)), and ``sin_cos_turns`` gives cos and sin (ops/cuda/mathfns.py),
each times amp.

- ``nco_planes``: (re, im), each (n,) float32: the reference's
  (n/128, 128) planes, flattened; any n.
- ``nco_folded``: (R, 128) float32 in the time-folded-lanes layout of the
  wideband-FM chain: lane s = re(sample s*R + r), lane 64+s = im.

The plain versions compute the accumulator in int64 masked to 32 bits and
the rest with torch's float32 ops; the kernels (``csrc/sources.cu``) round
every step the same way, so the two agree bit for bit. ``phase0`` and
``dphase`` are the blocks' stream state and parameter: int64 tensors on the
run's device holding the uint32 values, which the kernels read from the
card (so a captured step replays with the phase the step before left), or
host ints (a test's, a probe's), uploaded for the launch; ``amp`` is a
float32 scalar, a 0-dim tensor on the device or a number.
"""

from __future__ import annotations

import ctypes

import torch

from newsched_tpu_torch.ops.cuda import _build
from newsched_tpu_torch.ops.cuda.mathfns import SINCOS_COEFFS, sin_cos_turns_plain

S = 64  # fold width of the folded layout: segments = lane pairs
_M32 = 0xFFFFFFFF
_T2 = 1.0 / (1 << 32)  # turns per phase unit (exact in float32)


def nco_turns(phase0, dphase, idx: torch.Tensor) -> torch.Tensor:
    """float32 turns in [-0.5, 0.5) of the samples at int64 indices ``idx``
    (negative indices wrap modulo 2^32, as the uint32 accumulator does);
    ``phase0``/``dphase`` host ints or int64 tensors."""
    acc = (phase0 + idx * dphase) & _M32
    signed = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    return signed.to(torch.float32) * _T2


def _amp(amp, device) -> torch.Tensor:
    return torch.as_tensor(amp, dtype=torch.float32, device=device).reshape(1)


def nco_args(phase0, dphase, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The phase and its increment as the kernels read them: int64 on
    ``device`` (host ints are uploaded; keep the tensors alive until the
    launch)."""
    return tuple(_build.device_scalar(v, name, device=device, dtype=torch.int64)
                 for v, name in ((phase0, "phase"), (dphase, "dphase")))


def nco_planes_plain(phase0, dphase, amp, n: int, device):
    """The plain PyTorch version of ``nco_planes``."""
    t = nco_turns(phase0, dphase, torch.arange(int(n), device=device))
    sn, cs = sin_cos_turns_plain(t)
    a = _amp(amp, device)
    return cs * a, sn * a


def nco_planes(phase0, dphase, amp, n: int, device):
    """One batch of n samples of the tone as (re, im) float32 planes, each
    (n,). CPU tensors take the plain version; on a CUDA device it launches
    ``nco_planes_launch`` (csrc/sources.cu, kernel K8)."""
    device = torch.device(device)
    if device.type == "cpu":
        return nco_planes_plain(phase0, dphase, amp, n, device)
    a = _amp(amp, device)
    device = a.device  # "cuda" -> the current card, "cuda:0"
    ph, dp = nco_args(phase0, dphase, device)
    re = torch.empty(int(n), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    with torch.cuda.device(device):
        err = _build.lib().nco_planes_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), int(n),
            re.data_ptr(), im.data_ptr(),
            SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "nco_planes_launch")
    nco_planes.launches += 1
    return re, im


nco_planes.launches = 0


def folded_index(R: int, r_lo: int, rows: int, device) -> torch.Tensor:
    """(rows, 2S) int64 batch sample index of each element of rows
    [r_lo, r_lo + rows) in the folded layout: segment (lane mod S) * R +
    row."""
    row = torch.arange(int(r_lo), int(r_lo) + int(rows), device=device)[:, None]
    seg = torch.arange(2 * S, device=device)[None, :] % S
    return seg * int(R) + row


def folded_values(phase0, dphase, amp, idx: torch.Tensor):
    """The folded-layout tone at the sample indices ``idx`` (2S lanes):
    cos * amp in the first S lanes, sin * amp in the last S."""
    sn, cs = sin_cos_turns_plain(nco_turns(phase0, dphase, idx))
    lane = torch.arange(2 * S, device=idx.device)
    return torch.where(lane < S, cs, sn) * _amp(amp, idx.device)


def shard_phase(phase0, dphase, shard: int, R: int):
    """The phase at time shard ``shard``'s first sample, a batch's shards
    being 64*R samples each (host ints or int64 tensors)."""
    return (phase0 + dphase * (int(shard) * S * int(R))) & _M32 if shard \
        else phase0


def mask_before_stream(x: torch.Tensor, idx: torch.Tensor, first,
                       shard: int = 0) -> torch.Tensor:
    """``x`` with the samples at negative batch indices set to 0 where they
    lie before the stream: on shard 0 of the stream's first batch
    (``first``: a bool, or the blocks' bool flag on the device)."""
    if shard or (not isinstance(first, torch.Tensor) and not first):
        return x
    pre = (idx < 0) & torch.as_tensor(first, device=idx.device)
    return torch.where(pre, torch.zeros((), device=x.device), x)


def nco_folded_plain(phase0, dphase, amp, R: int, device):
    """The plain PyTorch version of ``nco_folded``."""
    return folded_values(phase0, dphase, amp, folded_index(R, 0, R, device))


def nco_folded(phase0, dphase, amp, R: int, device):
    """One batch of 64*R samples of the tone as (R, 128) time-folded planes.
    CPU tensors take the plain version; on a CUDA device it launches
    ``nco_folded_launch`` (csrc/sources.cu, kernel K11)."""
    device = torch.device(device)
    if device.type == "cpu":
        return nco_folded_plain(phase0, dphase, amp, R, device)
    a = _amp(amp, device)
    device = a.device  # "cuda" -> the current card, "cuda:0"
    ph, dp = nco_args(phase0, dphase, device)
    out = torch.empty((int(R), 2 * S), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _build.lib().nco_folded_launch(
            ph.data_ptr(), dp.data_ptr(), a.data_ptr(), int(R),
            out.data_ptr(), SINCOS_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "nco_folded_launch")
    nco_folded.launches += 1
    return out


nco_folded.launches = 0
