"""Fixed-point numerically-controlled oscillator (reference:
newsched_tpu/ops/nco.py).

The phase is a 32-bit fixed-point accumulator, one turn = 2^32 units, so
a stream keeps its phase exactly however long it runs. A batch's phases
are ``phase0 + k * dphase`` (mod 2^32), computed all at once.

torch has no full uint32 arithmetic (and little of it on CUDA), so
tensors carry phases as int64 masked to 32 bits (``k * dphase`` stays
below 2^63 for any batch under 2^31 samples). The blocks keep the
per-batch state (``phase0``) and the increment (``dphase``) on the run's
device as 0-dim int64 tensors holding the uint32 values, and advance the
phase there, so no step reads a value back and a captured step replays
with the phase the step before left; every function here takes those
tensors or host ints alike.
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


def nco_phase(phase0, dphase, n: int, device) -> torch.Tensor:
    """Phases in radians (float32, [0, 2*pi)) of n consecutive samples:
    the unsigned accumulator phase0 + k * dphase (mod 2^32) converted to
    float32, times 2*pi / 2^32."""
    k = torch.arange(n, dtype=torch.int64, device=device)
    acc = (phase0 + k * dphase) & _M32
    return acc.to(torch.float32) * _PHASE_TO_RAD


def nco_advance(phase0, dphase, n: int):
    """The accumulator after n samples (exact modulo 2^32): a host int for
    host ints, else a new int64 tensor on their device (no read-back)."""
    return (phase0 + int(n) * dphase) & _M32


def phase_tensor(phase, device) -> torch.Tensor:
    """An NCO phase (or increment) as the blocks keep it: a 0-dim int64
    tensor on ``device`` holding the uint32 value."""
    if isinstance(phase, torch.Tensor):
        return phase.to(device=device, dtype=torch.int64) & _M32
    return torch.tensor(int(phase) & _M32, dtype=torch.int64, device=device)


def nco_cexp(phase0, dphase, n: int, device,
             conj: bool = False) -> torch.Tensor:
    """exp(+/- j*phase[k]) for k in [0, n) as complex64 (the rotator
    stream)."""
    ph = nco_phase(phase0, dphase, n, device)
    c, s = torch.cos(ph), torch.sin(ph)
    return torch.complex(c, -s if conj else s)
