"""Carrier and symbol-timing recovery feedback loops (reference:
newsched_tpu/ops/loops.py): digital::costas_loop_cc,
digital::clock_recovery_mm_cc and the 2nd-order control_loop gain design
they share.

Both recurrences are nonlinear (each step decides on the previous
corrected output), so there is no associative form. The reference runs
each as one ``lax.scan`` and ``vmap``s it across channels; here each is a
CUDA kernel (S1, S2 in ops/cuda/loops.py), one thread a stream, and the
``vmap`` is written out: inputs may carry leading stream dimensions
(``x`` of shape (..., N), every state field of shape (...)). On CPU
tensors the plain versions run the same loops in torch. The state is an
explicit NamedTuple, so batch splits are exact (N batches = 1 batch, bit
for bit), as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import loops as _k

def loop_coeffs(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0):
    """(alpha, beta) for a critically-damped 2nd-order loop, the standard
    control_loop gain design: denom = 1 + 2*d*bw + bw^2 (float64, then
    float32, as the reference designs a host loop_bw)."""
    bw = float(loop_bw)
    d = float(damping)
    denom = 1.0 + 2.0 * d * bw + bw * bw
    alpha = 4.0 * d * bw / denom
    beta = 4.0 * bw * bw / denom
    return np.float32(alpha), np.float32(beta)


_wrap_phase = _k.wrap_phase        # wrap to (-pi, pi], round half to even
_costas_error = _k.costas_error    # the order-2/4/8 phase detector


# -- Costas loop (carrier phase and frequency recovery) ----------------------

class CostasState(NamedTuple):
    phase: torch.Tensor  # float32, radians
    freq: torch.Tensor   # float32, radians/sample


def costas_init_state(phase: float = 0.0, freq: float = 0.0,
                      device="cuda") -> CostasState:
    z = dict(dtype=torch.float32, device=device)
    return CostasState(phase=torch.tensor(float(np.float32(phase)), **z),
                       freq=torch.tensor(float(np.float32(freq)), **z))


def costas_loop(state: CostasState, x: torch.Tensor, loop_bw, order: int = 4,
                max_freq: float = 1.0) -> tuple[CostasState, torch.Tensor]:
    """De-rotate a batch by a decision-directed 2nd-order PLL.

    Per sample: y = x * exp(-j*phase); e = detector(y) clipped to +-1;
    freq += beta*e (clamped to +-max_freq); phase += freq + alpha*e
    (wrapped). ``loop_bw`` is a number (alpha and beta designed on the
    host, in float64) or a 0-dim tensor (a settable parameter: designed in
    float32 where it lies, so a change needs no recapture)."""
    if order not in _k.ORDERS:
        raise ValueError(f"costas order must be 2, 4, or 8 (got {order})")
    lead, n = tuple(x.shape[:-1]), int(x.shape[-1])
    if isinstance(loop_bw, (int, float)):  # np.float32 is traced there too
        alpha, beta = loop_coeffs(loop_bw)
        bw = None
    else:
        alpha = beta = 0.0
        bw = torch.as_tensor(loop_bw, dtype=torch.float32, device=x.device)
    y, phase, freq = _k.costas_loop(
        x.to(torch.complex64).reshape(-1, n).contiguous(),
        state.phase.reshape(-1).contiguous(), state.freq.reshape(-1).contiguous(),
        bw, float(alpha), float(beta), order, max_freq)
    return (CostasState(phase=phase.reshape(lead), freq=freq.reshape(lead)),
            y.reshape(x.shape).to(x.dtype))


# -- Mueller & Muller clock recovery (symbol timing) -------------------------

class MMState(NamedTuple):
    hist: torch.Tensor   # (..., H) complex64 input tail carried across batches
    pos: torch.Tensor    # int64: read position into [hist | batch]
    mu: torch.Tensor     # float32 in [0, 1): fractional sample offset
    omega: torch.Tensor  # float32: samples per symbol estimate
    p1: torch.Tensor     # previous interpolated sample
    p2: torch.Tensor     # the one before that
    c1: torch.Tensor     # previous decision
    c2: torch.Tensor     # decision before that


def mm_history_len(sps: int) -> int:
    """History carried between batches: headroom for the loop to read behind
    the batch boundary while the timing estimate wanders. 16 symbols deep."""
    return 16 * int(sps) + 2


def mm_init_state(sps: int, device="cuda",
                  dtype=torch.complex64) -> MMState:
    h = mm_history_len(sps)
    z = torch.zeros((), dtype=dtype, device=device)
    return MMState(
        hist=torch.zeros((h,), dtype=dtype, device=device),
        pos=torch.tensor(h, dtype=torch.int64, device=device),
        mu=torch.tensor(0.5, dtype=torch.float32, device=device),
        omega=torch.tensor(float(sps), dtype=torch.float32, device=device),
        p1=z, p2=z.clone(), c1=z.clone(), c2=z.clone())


def _slicer(y: torch.Tensor) -> torch.Tensor:
    """Nearest-quadrant decision in {+-1 +-1j} (0-degree slicer)."""
    one = torch.ones_like(y.real)
    return torch.complex(torch.where(y.real >= 0, one, -one),
                         torch.where(y.imag >= 0, one, -one))


def clock_recovery_mm(state: MMState, x: torch.Tensor, sps: int, gain_omega,
                      gain_mu, omega_relative_limit: float = 0.005
                      ) -> tuple[MMState, torch.Tensor]:
    """Mueller & Muller decision-directed timing recovery.

    Consumes len(x) samples, produces exactly len(x)//sps symbols (the
    static rate the compiler's algebra needs): a read position into
    ``[hist | batch]`` with linear interpolation at the fractional offset,
    carried in the state. Timing error: e = Re{(p0-p2)conj(c1) -
    (c0-c2)conj(p1)}, p the interpolated samples and c their decisions;
    omega clamped to sps(1 +- omega_relative_limit). The position is not
    clamped inside a batch (the window read clamps its start, as the
    reference's dynamic_slice does), and is rebased between batches, so N
    batches equal one. The gains are numbers or 0-dim tensors."""
    sps = int(sps)
    lead, n = tuple(x.shape[:-1]), int(x.shape[-1])
    nout = n // sps
    if nout * sps != n:
        raise ValueError("batch length must be a multiple of sps")
    h = int(state.hist.shape[-1])

    def flat(t):
        return t.reshape(-1).contiguous()

    y, hist, pos, mu, omega, p1, p2, c1, c2 = _k.clock_recovery_mm(
        x.to(torch.complex64).reshape(-1, n).contiguous(),
        state.hist.reshape(-1, h).contiguous(), flat(state.pos),
        flat(state.mu), flat(state.omega), flat(state.p1), flat(state.p2),
        flat(state.c1), flat(state.c2), sps, gain_omega, gain_mu,
        omega_relative_limit)
    st = MMState(hist=hist.reshape(*lead, h),
                 **{k: v.reshape(lead) for k, v in zip(
                     MMState._fields[1:], (pos, mu, omega, p1, p2, c1, c2))})
    return st, y.reshape(*lead, nout).to(x.dtype)
