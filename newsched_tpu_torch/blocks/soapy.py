"""SoapySDR hardware source and sink (reference:
newsched_tpu/blocks/soapy.py, GNU Radio's blocklib/soapy).

Gated on the ``SoapySDR`` Python module: a block constructs anywhere, and
start() raises a clear ImportError where the driver stack is absent. The
stream goes through the runner's host_pull/host_push boundary, as the file
and socket blocks' does, so a machine with SoapySDR needs nothing more.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype


def _soapy():
    try:
        import SoapySDR  # type: ignore

        return SoapySDR
    except ImportError as e:
        raise ImportError(
            "SoapySDR python bindings not available on this host; "
            "newsched_tpu_torch.blocks.soapy requires the SoapySDR driver stack "
            "(reference blocklib/soapy has the same hard dependency)"
        ) from e


class source(Block):
    """RX stream from SDR hardware (reference soapy::source)."""

    host_io = True

    def __init__(self, device_args: str = "", sample_rate: float = 1e6,
                 frequency: float = 100e6, gain: float = 20.0, channel: int = 0,
                 dtype="cf32", name=None):
        super().__init__(name)
        self.device_args = device_args
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self.channel = channel
        self.dtype = port_dtype(dtype)
        self.add_output("out", self.dtype)
        self._dev = None
        self._stream = None

    def start(self):
        S = _soapy()
        self._dev = S.Device(self.device_args)
        self._dev.setSampleRate(S.SOAPY_SDR_RX, self.channel, self.sample_rate)
        self._dev.setFrequency(S.SOAPY_SDR_RX, self.channel, self.frequency)
        self._dev.setGain(S.SOAPY_SDR_RX, self.channel, self.gain)
        self._stream = self._dev.setupStream(S.SOAPY_SDR_RX, "CF32", [self.channel])
        self._dev.activateStream(self._stream)

    def stop(self):
        if self._dev is not None and self._stream is not None:
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
            self._stream = None
            self._dev = None

    def host_pull(self, nout: int) -> np.ndarray:
        out = np.empty(nout, np.complex64)
        got = 0
        while got < nout:
            sr = self._dev.readStream(self._stream, [out[got:]], nout - got)
            if sr.ret > 0:
                got += sr.ret
        return out

    def work(self, state, ins, params, nout):
        return state, {"out": ins["host_in"]}


class sink(Block):
    """TX stream to SDR hardware (reference soapy::sink)."""

    host_io = True

    def __init__(self, device_args: str = "", sample_rate: float = 1e6,
                 frequency: float = 100e6, gain: float = 20.0, channel: int = 0,
                 dtype="cf32", name=None):
        super().__init__(name)
        self.device_args = device_args
        self.sample_rate = sample_rate
        self.frequency = frequency
        self.gain = gain
        self.channel = channel
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype)
        self._dev = None
        self._stream = None

    def start(self):
        S = _soapy()
        self._dev = S.Device(self.device_args)
        self._dev.setSampleRate(S.SOAPY_SDR_TX, self.channel, self.sample_rate)
        self._dev.setFrequency(S.SOAPY_SDR_TX, self.channel, self.frequency)
        self._dev.setGain(S.SOAPY_SDR_TX, self.channel, self.gain)
        self._stream = self._dev.setupStream(S.SOAPY_SDR_TX, "CF32", [self.channel])
        self._dev.activateStream(self._stream)

    def stop(self):
        if self._dev is not None and self._stream is not None:
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
            self._stream = None
            self._dev = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def host_push(self, batch: np.ndarray) -> None:
        sent = 0
        arr = np.ascontiguousarray(batch, np.complex64)
        while sent < len(arr):
            sr = self._dev.writeStream(self._stream, [arr[sent:]], len(arr) - sent)
            if sr.ret > 0:
                sent += sr.ret

    def finalize(self, collected, total):
        pass
