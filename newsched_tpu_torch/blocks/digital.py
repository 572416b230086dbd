"""Digital blocks (reference: newsched_tpu/blocks/digital.py, the
reference's blocklib/digital): constellation objects, symbol mapping and
slicing, a differential codec, and the carrier and timing recovery loops
that complete a coherent receiver (costas_loop, clock_recovery_mm; GNU
Radio digital lineage). Mapping and slicing are tensor ops; the feedback
loops are S1 and S2 (ops/loops.py) on the card, with exact batch-split
invariance.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import loops as loop_ops
from newsched_tpu_torch.runtime.block import Block, SyncBlock


class Constellation:
    """Constellation object (reference digital::constellation): points +
    bits-per-symbol + nearest-point decision."""

    def __init__(self, points, name: str = "custom"):
        self.points = np.asarray(points, dtype=np.complex64)
        self.name = name
        self.bits_per_symbol = int(np.log2(len(self.points)))
        if 2 ** self.bits_per_symbol != len(self.points):
            raise ValueError("constellation size must be a power of 2")
        self._dev: dict = {}

    @classmethod
    def bpsk(cls):
        return cls([-1 + 0j, 1 + 0j], "bpsk")

    @classmethod
    def qpsk(cls):
        s = 1 / np.sqrt(2)
        return cls([s * (-1 - 1j), s * (-1 + 1j), s * (1 - 1j), s * (1 + 1j)],
                   "qpsk")

    @classmethod
    def psk(cls, m: int, rot: float = 0.0):
        """M-PSK at angles 2*pi*k/m + rot. With rot=pi/4, m=4 this is the
        diagonal QPSK whose index space makes carrier-phase ambiguity a
        +k (mod 4) shift, which diff_encoder/diff_decoder resolve, and the
        lock geometry the order-4 costas detector assumes."""
        k = np.arange(m)
        return cls(np.exp(1j * (2 * np.pi * k / m + rot)), f"{m}psk")

    @classmethod
    def qam16(cls):
        re, im = np.meshgrid([-3, -1, 1, 3], [-3, -1, 1, 3])
        pts = (re + 1j * im).reshape(-1) / np.sqrt(10)
        return cls(pts, "qam16")

    def device_points(self, device) -> torch.Tensor:
        """The points as a complex64 tensor on ``device`` (kept)."""
        key = torch.device(device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.points, device=key)
        return self._dev[key]

    def decide(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-point indices (int32) for a batch of samples."""
        pts = self.device_points(x.device)
        d = (x[:, None] - pts[None, :]).abs() ** 2
        return torch.argmin(d, dim=1).to(torch.int32)


class chunks_to_symbols(SyncBlock):
    """Map symbol indices to constellation points (reference
    digital::chunks_to_symbols)."""

    def __init__(self, constellation: Constellation, name=None):
        super().__init__(name)
        self.constellation = constellation
        self.add_input("in", "ri32")
        self.add_output("out", "cf32")

    def work(self, state, ins, params, nout):
        idx = ins["in"]
        pts = self.constellation.device_points(idx.device)
        return state, {"out": pts[idx.to(torch.int64)]}


class constellation_decoder(SyncBlock):
    """Hard-decision nearest-point decoder (reference
    digital::constellation_decoder_cb)."""

    def __init__(self, constellation: Constellation, name=None):
        super().__init__(name)
        self.constellation = constellation
        self.add_input("in", "cf32")
        self.add_output("out", "ri32")

    def work(self, state, ins, params, nout):
        return state, {"out": self.constellation.decide(ins["in"])}


class binary_slicer(SyncBlock):
    """rf32 -> 0/1 by sign (reference digital::binary_slicer_fb)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.add_input("in", "rf32")
        self.add_output("out", "ri32")

    def work(self, state, ins, params, nout):
        return state, {"out": (ins["in"] >= 0).to(torch.int32)}


class diff_encoder(Block):
    """Differential encoder y[n] = (x[n] + y[n-1]) mod M (reference
    digital::diff_encoder). With modular arithmetic the recurrence is a
    prefix sum: y[n] = (cumsum(x)[n] + y[-1]) mod M, in int32 (wrapping as
    the reference's does), floor modulus as jnp.mod."""

    def __init__(self, modulus: int, name=None):
        super().__init__(name)
        self.modulus = int(modulus)
        self.add_input("in", "ri32")
        self.add_output("out", "ri32")

    def init_state(self, nin, nout, device):
        return {"prev": torch.zeros((), dtype=torch.int32, device=device)}

    def work(self, state, ins, params, nout):
        c = torch.cumsum(ins["in"], 0, dtype=torch.int32) + state["prev"]
        y = torch.remainder(c, self.modulus).to(torch.int32)
        return {"prev": y[-1]}, {"out": y}


class diff_decoder(Block):
    """y[n] = (x[n] - x[n-1]) mod M (reference digital::diff_decoder)."""

    def __init__(self, modulus: int, name=None):
        super().__init__(name)
        self.modulus = int(modulus)
        self.add_input("in", "ri32")
        self.add_output("out", "ri32")

    def init_state(self, nin, nout, device):
        return {"prev": torch.zeros((), dtype=torch.int32, device=device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        xprev = torch.cat([state["prev"][None], x[:-1]])
        y = torch.remainder(x - xprev, self.modulus).to(torch.int32)
        return {"prev": x[-1]}, {"out": y}


class costas_loop(SyncBlock):
    """Decision-directed carrier recovery PLL (reference
    digital::costas_loop_cc): de-rotates residual carrier phase and
    frequency for order-2/4/8 PSK. ``loop_bw`` is settable (its tensor is
    read on the card, so a change needs no recapture). Kernel: S1
    (ops/loops.costas_loop)."""

    def __init__(self, loop_bw: float, order: int = 4, max_freq: float = 1.0,
                 name=None):
        super().__init__(name)
        self.order = int(order)
        self.max_freq = float(max_freq)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        self.declare_param("loop_bw", np.float32(loop_bw))

    def init_state(self, nin, nout, device):
        return loop_ops.costas_init_state(device=device)

    def work(self, state, ins, params, nout):
        st, y = loop_ops.costas_loop(state, ins["in"], params["loop_bw"],
                                     order=self.order, max_freq=self.max_freq)
        return st, {"out": y}


class clock_recovery_mm(Block):
    """Mueller & Muller decision-directed symbol timing recovery (reference
    digital::clock_recovery_mm_cc). Consumes sps samples per output symbol,
    a static 1/sps rate so the compiler's rate algebra holds; the timing
    estimate tracks fractional offsets and bounded ppm drift inside a
    16-symbol history window. ``gain_omega`` and ``gain_mu`` are settable.
    Kernel: S2 (ops/loops.clock_recovery_mm)."""

    def __init__(self, sps: int, gain_omega: float | None = None,
                 gain_mu: float = 0.05, omega_relative_limit: float = 0.005,
                 name=None):
        super().__init__(name)
        self.sps = int(sps)
        self.omega_relative_limit = float(omega_relative_limit)
        self.relative_rate = Fraction(1, self.sps)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        if gain_omega is None:
            gain_omega = 0.25 * gain_mu * gain_mu
        self.declare_param("gain_omega", np.float32(gain_omega))
        self.declare_param("gain_mu", np.float32(gain_mu))

    def init_state(self, nin, nout, device):
        return loop_ops.mm_init_state(self.sps, device=device)

    def work(self, state, ins, params, nout):
        st, y = loop_ops.clock_recovery_mm(
            state, ins["in"], self.sps, params["gain_omega"],
            params["gain_mu"], omega_relative_limit=self.omega_relative_limit)
        return st, {"out": y}
