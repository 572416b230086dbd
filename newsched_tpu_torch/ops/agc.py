"""AGC (automatic gain control) as an affine scan (reference:
newsched_tpu/ops/agc.py).

Reference semantics (kernel/include/gnuradio/kernel/analog/agc.h): per
sample, output = input * gain, then gain += rate * (reference - |output|),
which is the affine recurrence

    g[n+1] = g[n] * (1 - rate*|x[n]|) + rate*reference.

The reference solves it with ``lax.associative_scan``; torch has none. On
a CUDA tensor ``agc`` launches S5 (ops/cuda/scan.py ``agc_scan``,
csrc/scan.cu), one launch a call. On a CPU tensor it runs the plain
version, ``agc_plain``: the prefix compositions of the affine maps from a
doubling (Hillis-Steele) scan, log2(n) passes of whole-batch tensor ops.
The state is the one carried gain, so batch splits are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from newsched_tpu_torch.ops.cuda import scan as kscan


class AgcState(NamedTuple):
    gain: torch.Tensor  # float32, 0-dim


def agc_init_state(initial_gain: float = 1.0, device="cuda") -> AgcState:
    return AgcState(gain=torch.tensor(float(initial_gain), dtype=torch.float32,
                                      device=device))


def affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix compositions of the maps g -> a[n] g + b[n] along
    the last axis: (A, B) with g[n+1] = A[n] g[0] + B[n]."""
    n, d = int(a.shape[-1]), 1
    while d < n:
        a_prev, b_prev = a[..., :-d], b[..., :-d]
        b = torch.cat([b[..., :d], a[..., d:] * b_prev + b[..., d:]], -1)
        a = torch.cat([a[..., :d], a[..., d:] * a_prev], -1)
        d *= 2
    return a, b


def agc(state: AgcState, x: torch.Tensor, rate, reference,
        max_gain: float = 0.0, workspace: kscan.AgcWorkspace | None = None):
    """Apply AGC over one batch; max_gain <= 0 disables the clamp. Works
    for complex64 and float32 inputs (envelope |x|), as agc_cc / agc_ff.
    ``rate`` and ``reference`` are numbers or 0-dim tensors. S5 on a CUDA
    tensor (``workspace``: its flags, ``kscan.agc_workspace(n, device)``,
    made for the call when None), the plain version on a CPU one."""
    if x.device.type == "cpu":
        return agc_plain(state, x, rate, reference, max_gain)
    y, gain = kscan.agc_scan(x.contiguous(), state.gain, rate, reference,
                             max_gain, workspace)
    return AgcState(gain=gain), y


def agc_plain(state: AgcState, x: torch.Tensor, rate, reference,
              max_gain: float = 0.0):
    """The plain version, on any device: ``affine_scan``, then the gains
    and the clamp."""
    mag = x.abs().to(torch.float32)
    rate = torch.as_tensor(rate, dtype=torch.float32, device=x.device)
    reference = torch.as_tensor(reference, dtype=torch.float32,
                                device=x.device)
    a = 1.0 - rate * mag
    b = (rate * reference).expand_as(mag)
    A, B = affine_scan(a, b)
    g0 = state.gain
    gains_after = A * g0 + B  # g[n+1] for each n
    gains = torch.cat([g0.reshape(1), gains_after[:-1]])  # g[n] for x[n]
    new_gain = gains_after[-1]
    # the clamp breaks associativity, so it is applied after the scan, as
    # in the reference (the same behaviour in its stable operating region)
    if max_gain > 0:
        gains = torch.clamp(gains, max=float(max_gain))
        new_gain = torch.clamp(new_gain, max=float(max_gain))
    y = x * gains.to(x.dtype)
    return AgcState(gain=new_gain), y.to(x.dtype)
