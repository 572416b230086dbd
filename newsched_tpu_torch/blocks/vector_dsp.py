"""Vector-stream DSP blocks of the fused flagship (reference:
newsched_tpu/blocks/vector_dsp.py): the planes-rows source and adapter,
and the fused channelizer block.

As in the reference, one block processes all M channels as one batched
kernel: the per-channel axis is the kernel's lane axis.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import firdes, pfb as pfb_ops
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.runtime.block import Block


class cplx_to_planes(Block):
    """Adapter: cf32 scalar stream -> the planes-rows stream format of the
    fused FM chain (ops/cuda/fm_chain.py): rf32[(2M,)] rows, row k =
    [re | im] of x[kM-(M-1) .. kM]. Carries the M-1-sample skew between
    batches."""

    def __init__(self, nchans: int, name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self.add_input("in", "cf32")
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))

    def init_state(self, nin, nout, device):
        return {"skew": torch.zeros((self.nchans - 1,), dtype=torch.complex64,
                                    device=device)}

    def work(self, state, ins, params, nout):
        M = self.nchans
        full = torch.cat([state["skew"], ins["in"]])
        rows = full[: nout * M].reshape(nout, M)
        planes = torch.cat([rows.real, rows.imag], dim=1).to(torch.float32)
        return {"skew": full[nout * M:]}, {"out": planes}


class noise_planes_source(Block):
    """Gaussian noise emitted directly in planes-rows format: the
    no-prep-pass producer for the fused FM chain (each lane is an i.i.d.
    draw, so the M-1-sample skew of the row convention is immaterial).

    The stream is ops/cuda/noise.py's position-pure Philox + Irwin-Hall
    stream on every device (the CUDA kernel on a GPU, its bit-identical
    plain version on the CPU), deterministic in (seed, absolute 64-row
    group): batches must be multiples of 64 rows. Method names:
    "auto" and "pallas" select it (the reference's "pallas" is its
    TPU-hardware stream, which this one replaces); "pure" is the
    reference's portable position-pure stream, which this one also
    replaces. "threefry" raises: its bits come from jax's key chaining,
    which the port does not reproduce.
    """

    def __init__(self, nchans: int, amplitude: float = 1.0, seed: int = 0,
                 method: str = "auto", name=None):
        super().__init__(name)
        if method == "threefry":
            raise NotImplementedError(
                "noise_planes_source(method='threefry'): jax.random's key "
                "chaining has no port; use 'auto' (position-pure Philox)")
        if method not in ("auto", "pallas", "pure"):
            raise ValueError(f"method {method!r} not in auto/pallas/pure")
        self.nchans = int(nchans)
        self.seed = int(seed)
        self.method = method
        self.add_output("out", "rf32", item_shape=(2 * self.nchans,))
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def init_state(self, nin, nout, device):
        if nout % noise.GROUP_ROWS:
            raise ValueError(
                f"noise_planes_source needs batches in multiples of "
                f"{noise.GROUP_ROWS} rows, got {nout}")
        return {"ghi": 0, "glo": 0}

    def work(self, state, ins, params, nout):
        amp = params["amplitude"]
        r = noise.gaussian_rows(state["ghi"], state["glo"], n_rows=nout,
                                width=2 * self.nchans, seed=self.seed,
                                device=amp.device)
        hi, lo = noise.advance_groups(state["ghi"], state["glo"],
                                      nout // noise.GROUP_ROWS)
        return {"ghi": hi, "glo": lo}, {"out": r * amp}


class fm_channelizer_fused_planes(Block):
    """The flagship chain as ONE block on the planes-rows stream:
    rf32[(2M,)] rows in -> rf32[(M,)] audio out at rate 1/decim, backed by
    the fused kernel (ops/cuda/fm_chain.py fm_chain_step_planes). The
    stream format is the kernel's native format, so source -> this block
    -> sink runs no layout conversion at all."""

    def __init__(self, nchans: int, taps, audio_taps, audio_decim: int = 8,
                 gain: float = 1.0, taps_per_arm: int | None = None,
                 precision="split3", name=None):
        super().__init__(name)
        self.nchans = int(nchans)
        if taps is None:
            taps = firdes.prototype_channelizer_taps(self.nchans,
                                                     taps_per_arm or 16)
        self.arm = pfb_ops.pfb_arm_taps(np.asarray(taps, np.float32), self.nchans)
        self.fold_c = np.asarray(self.arm)[::-1, ::-1].T.copy()
        self.audio_taps = np.asarray(audio_taps, np.float32)
        self.audio_decim = int(audio_decim)
        self.gain = float(gain)
        self.precision = precision
        self.h8 = fm_chain._round8(self.arm.shape[1] - 1)
        self.relative_rate = Fraction(1, self.audio_decim)
        self.add_input("in", "rf32", item_shape=(2 * self.nchans,))
        self.add_output("out", "rf32", item_shape=(self.nchans,))
        self._consts: dict[torch.device, fm_chain.FmChainConsts] = {}

    def consts(self, device) -> fm_chain.FmChainConsts:
        """The chain constants on ``device``, uploaded once per device."""
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = fm_chain.fm_chain_consts(
                self.fold_c, self.audio_taps, device)
        return self._consts[device]

    def init_state(self, nin, nout, device):
        M = self.nchans
        A = len(self.audio_taps)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return {"carry": z(self.h8, 2 * M), "prev": z(1, 2 * M),
                "atail": z(A - 1, 2 * M)}

    def work(self, state, ins, params, nout):
        x = ins["in"].contiguous()  # (n, 2M) planes rows
        aud, prev, atail = fm_chain.fm_chain_step_planes(
            x, state["carry"], state["prev"], state["atail"],
            self.consts(x.device), self.audio_decim, self.gain,
            precision=self.precision)
        n = int(x.shape[0])
        carry = (x[-self.h8:] if n >= self.h8
                 else torch.cat([state["carry"], x])[-self.h8:]).clone()
        return {"carry": carry, "prev": prev, "atail": atail}, {"out": aud}
