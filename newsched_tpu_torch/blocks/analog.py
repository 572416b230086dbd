"""Analog blocks (reference: newsched_tpu/blocks/analog.py): the noise
source of the staged flagship."""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import noise
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype

_WIDTH = 128  # stream words per generated row, as the reference's kernel


class noise_source(Block):
    """Gaussian noise (reference analog::noise_source<T>), cf32 or rf32.

    The stream is ops/cuda/noise.py's position-pure Philox + Irwin-Hall
    stream (the CUDA kernel on a GPU, its bit-identical plain version on
    the CPU), generated as rows of 128 float32 words, as the reference's
    hardware-PRNG engine does: rf32 reads the rows in order; cf32 takes
    each row's first 64 words as real parts and the last 64 as imaginary
    parts. Each of I/Q is a full-amplitude draw. Deterministic in (seed,
    absolute 64-row group), so a batch's word count (2 per cf32 item)
    must be a multiple of 64 * 128 = 8192.

    Method names: "auto" and "pallas" select this stream (the reference's
    "pallas" is its TPU-hardware stream, which this one replaces).
    "threefry" and uniform noise raise: their bits come from jax.random's
    key chaining, which the port does not reproduce.
    """

    def __init__(self, noise_type: str = "gaussian", amplitude: float = 1.0,
                 seed: int = 0, dtype="cf32", method: str = "auto", name=None):
        super().__init__(name)
        if method == "threefry":
            raise NotImplementedError(
                "noise_source(method='threefry'): jax.random's key chaining "
                "has no port; use 'auto' (position-pure Philox)")
        if method not in ("auto", "pallas"):
            raise ValueError(f"method {method!r} not in auto/pallas/threefry")
        if noise_type != "gaussian":
            raise NotImplementedError(
                f"noise_source({noise_type!r}): the reference draws "
                "non-gaussian noise from jax.random (threefry), which has no "
                "port; gaussian noise comes from the Philox stream")
        self.dtype = port_dtype(dtype)
        if self.dtype.name not in ("cf32", "rf32"):
            raise NotImplementedError(
                f"noise_source dtype {self.dtype.name}: the Philox stream "
                "emits cf32 or rf32")
        self.noise_type = noise_type
        self.seed = int(seed)
        self.method = method
        self.add_output("out", self.dtype)
        self.declare_param("amplitude", amplitude, dtype=np.float32)

    def _words(self, nout: int) -> int:
        return nout * (2 if self.dtype.name == "cf32" else 1)

    def init_state(self, nin, nout, device):
        if self._words(nout) % (noise.GROUP_ROWS * _WIDTH):
            raise ValueError(
                f"noise_source needs batches whose f32 word count is a "
                f"multiple of {noise.GROUP_ROWS * _WIDTH}, got "
                f"{self._words(nout)} ({nout} {self.dtype.name} items)")
        return {"ghi": 0, "glo": 0}

    def work(self, state, ins, params, nout):
        a = params["amplitude"]
        n_rows = self._words(nout) // _WIDTH
        r = noise.gaussian_rows(state["ghi"], state["glo"], n_rows=n_rows,
                                width=_WIDTH, seed=self.seed, device=a.device)
        hi, lo = noise.advance_groups(state["ghi"], state["glo"],
                                      n_rows // noise.GROUP_ROWS)
        if self.dtype.name == "cf32":
            half = _WIDTH // 2
            y = torch.complex(r[:, :half].reshape(-1) * a,
                              r[:, half:].reshape(-1) * a)
        else:
            y = r.reshape(-1) * a
        return {"ghi": hi, "glo": lo}, {"out": y}
