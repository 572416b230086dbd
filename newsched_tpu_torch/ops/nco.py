"""Fixed-point numerically-controlled oscillator (reference:
newsched_tpu/ops/nco.py).

The phase is a 32-bit fixed-point accumulator, one turn = 2^32 units, so
a stream keeps its phase exactly however long it runs. A batch's phases
are ``phase0 + k * dphase`` (mod 2^32), computed all at once.

torch has no full uint32 arithmetic, so tensors carry phases as int64
masked to 32 bits (``k * dphase`` stays below 2^63 for any batch under
2^31 samples); the per-batch state (``phase0``, ``dphase``) is a host
int, as the stream position of every batch is known before it runs.
"""

from __future__ import annotations

import numpy as np
import torch

NCO_SCALE = float(2**32)
_M32 = 0xFFFFFFFF
_PHASE_TO_RAD = np.float32(2.0 * np.pi / NCO_SCALE)


def freq_to_dphase(freq: float, sampling_freq: float) -> int:
    """Per-sample phase increment for a tone at ``freq`` (host-side,
    exact). Negative frequencies map to their modulo-1-turn equivalent."""
    turns = (freq / sampling_freq) % 1.0
    return int(np.round(turns * NCO_SCALE) % NCO_SCALE)


def nco_phase(phase0: int, dphase: int, n: int, device) -> torch.Tensor:
    """Phases in radians (float32, [0, 2*pi)) of n consecutive samples:
    the unsigned accumulator phase0 + k * dphase (mod 2^32) converted to
    float32, times 2*pi / 2^32."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    acc = (int(phase0) + k * int(dphase)) & _M32
    return acc.to(torch.float32) * _PHASE_TO_RAD


def nco_advance(phase0: int, dphase: int, n: int) -> int:
    """The accumulator after n samples (exact modulo 2^32)."""
    return (int(phase0) + int(n) * int(dphase)) & _M32


def nco_cexp(phase0: int, dphase: int, n: int, device,
             conj: bool = False) -> torch.Tensor:
    """exp(+/- j*phase[k]) for k in [0, n) as complex64 (the rotator
    stream)."""
    ph = nco_phase(phase0, dphase, n, device)
    c, s = torch.cos(ph), torch.sin(ph)
    return torch.complex(c, -s if conj else s)
