"""Analog-domain ops: quadrature (FM) demod and frequency translation
(reference: newsched_tpu/ops/analog.py).

Both are elementwise over a batch once the one-sample history (demod) or
the NCO phase (rotator) is carried in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from newsched_tpu_torch.ops.nco import nco_advance, nco_cexp, phase_tensor


class QuadDemodState(NamedTuple):
    prev: torch.Tensor  # last input sample, complex64 shape ()


def quad_demod_init_state(device, dtype=torch.complex64) -> QuadDemodState:
    return QuadDemodState(prev=torch.zeros((), dtype=dtype, device=device))


def quadrature_demod(state: QuadDemodState, x: torch.Tensor, gain
                     ) -> tuple[QuadDemodState, torch.Tensor]:
    """FM discriminator over one batch: y[n] = gain * arg(conj(x[n-1]) x[n])
    -> float32."""
    xprev = torch.cat([state.prev[None], x[:-1]])
    p = torch.conj(xprev) * x
    # Zero-history convention: a demod against a zero sample emits exactly
    # 0 (atan2 of signed zeros differs between backends), as every other
    # demod path of the port and the reference.
    y = torch.where((xprev == 0) | (x == 0), torch.zeros((), device=x.device),
                    torch.atan2(p.imag, p.real)) * gain
    return QuadDemodState(prev=x[-1].clone()), y.to(torch.float32)


class RotatorState(NamedTuple):
    # the uint32 fixed-point phase accumulator: a 0-dim int64 tensor on the
    # run's device (advanced there, so no step reads it back)
    phase: torch.Tensor


def rotator_init_state(device="cuda") -> RotatorState:
    return RotatorState(phase=phase_tensor(0, device))


def rotate(state: RotatorState, x: torch.Tensor, dphase,
           conj: bool = False) -> tuple[RotatorState, torch.Tensor]:
    """Multiply a batch by exp(+/- j*phase[n]) from the exact fixed-point
    NCO: the frequency-translation front end of freq_xlating_fir."""
    n = int(x.shape[0])
    rot = nco_cexp(state.phase, dphase, n, x.device, conj=conj)
    return RotatorState(phase=nco_advance(state.phase, dphase, n)), x * rot
