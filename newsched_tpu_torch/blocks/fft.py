"""FFT block (reference: newsched_tpu/blocks/fft.py): a stream of
(fft_size,) vector items in, transformed vector items out, with an
optional window and shift (ops/fftops.py ``fft``: cuFFT on the card)."""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.ops import fftops
from newsched_tpu_torch.runtime.block import SyncBlock


class fft(SyncBlock):
    def __init__(self, fft_size: int, forward: bool = True, window=None,
                 shift: bool = False, name=None):
        super().__init__(name)
        self.fft_size = int(fft_size)
        self.forward = forward
        self.window = (None if window is None
                       else np.asarray(window, dtype=np.float32))
        self.shift = shift
        self.add_input("in", "cf32", item_shape=(self.fft_size,))
        self.add_output("out", "cf32", item_shape=(self.fft_size,))
        self._window: dict = {}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        w = None
        if self.window is not None:  # uploaded once per device
            if x.device not in self._window:
                self._window[x.device] = fftops.window_tensor(self.window,
                                                              x.device)
            w = self._window[x.device]
        return state, {"out": fftops.fft(x, self.forward, w, self.shift)}
