"""Filter blocks (reference: newsched_tpu/blocks/filter.py): the streaming
FIR of config #0; the polyphase channelizer and the single-channel
polyphase decimator; the frequency-translating FIR and the rational
resampler of the wideband-FM receiver."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import analog as analog_ops, fir as fir_ops, \
    firdes, nco, pfb as pfb_ops
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype


class fir_filter(Block):
    """Streaming FIR, optional decimation (reference filter::fir_filter):
    dtype in == dtype out (cf32 or rf32), taps real or complex, ``method``
    as ``ops/fir.py`` ``fir_filter`` takes it ("mxu3", config #0's, is its
    FP32 Toeplitz path). The taps' device constants are built once per
    device and batch shape."""

    def __init__(self, taps, decim: int = 1, dtype="cf32", method: str = "auto",
                 name=None):
        super().__init__(name)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.relative_rate = Fraction(1, self.decim)
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype)
        self.add_output("out", self.dtype)
        self._dev_taps: dict[tuple, fir_ops.FirTaps] = {}

    def init_state(self, nin, nout, device):
        return fir_ops.fir_init_state(len(self.taps), device,
                                      self.dtype.torch_dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"]
        key = (x.device, nout)
        if key not in self._dev_taps:
            self._dev_taps[key] = fir_ops.fir_taps(self.taps, nout, self.decim,
                                                   x.device)
        st, y = fir_ops.fir_filter(self.taps, state, x, decim=self.decim,
                                   method=self.method,
                                   dev_taps=self._dev_taps[key])
        return st, {"out": y}


class _pfb_block(Block):
    """What the two polyphase blocks share: the arm taps, their constants
    uploaded once per device, and the M*L-1-sample tail state."""

    def __init__(self, nchans: int, taps, name):
        super().__init__(name)
        self.nchans = int(nchans)
        self.taps = np.asarray(taps, dtype=np.float32)
        self.arm_taps = pfb_ops.pfb_arm_taps(self.taps, self.nchans)
        self.relative_rate = Fraction(1, self.nchans)
        self._consts: dict[torch.device, pfb_ops.PfbConsts] = {}

    def consts(self, device) -> pfb_ops.PfbConsts:
        device = torch.device(device)
        if device not in self._consts:
            self._consts[device] = pfb_ops.pfb_consts(self.arm_taps, device)
        return self._consts[device]

    def init_state(self, nin, nout, device):
        return pfb_ops.pfb_init_state(self.arm_taps.size, device)


class pfb_channelizer(_pfb_block):
    """M-channel polyphase channelizer (reference filter::pfb_channelizer):
    cf32 stream in -> stream of (M,)-vector items at rate 1/M, channel k
    centered at k/M of the input rate. When 2M is a multiple of 128 it runs
    the fused front end kernel (K1 ``arm_fold_dft``) on a GPU."""

    def __init__(self, nchans: int, taps=None, taps_per_arm: int = 16,
                 attenuation_db: float = 80.0, name=None):
        if taps is None:
            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm,
                                                     attenuation_db)
        super().__init__(nchans, taps, name)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32", item_shape=(self.nchans,))

    def work(self, state, ins, params, nout):
        x = ins["in"]
        st, Y = pfb_ops.pfb_channelize(self.arm_taps, state, x,
                                       consts=self.consts(x.device))
        return st, {"out": Y}


class pfb_decimator(_pfb_block):
    """Single-channel PFB decimator (reference filter::pfb_decimator): the
    fold kernel (K7 ``arm_fold``) and one weighted sum over the arms."""

    def __init__(self, nchans: int, channel: int = 0, taps=None,
                 taps_per_arm: int = 16, name=None):
        if taps is None:
            taps = firdes.prototype_channelizer_taps(nchans, taps_per_arm)
        super().__init__(nchans, taps, name)
        self.channel = int(channel)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")

    def work(self, state, ins, params, nout):
        x = ins["in"]
        st, y = pfb_ops.pfb_decimate(self.arm_taps, state, x, self.channel,
                                     consts=self.consts(x.device))
        return st, {"out": y}


class freq_xlating_fir(Block):
    """Down-convert by center_freq, filter, decimate (reference
    filter::freq_xlating_fir_filter): the exact fixed-point NCO rotator,
    then ``fir_filter`` (its Toeplitz product in FP32 for the usual tap
    counts). The taps' device constants are built once per device and
    batch shape."""

    def __init__(self, taps, center_freq: float, sampling_freq: float,
                 decim: int = 1, dtype="cf32", method: str = "auto", name=None):
        super().__init__(name)
        self.taps = np.asarray(taps)
        self.decim = int(decim)
        self.method = method
        self.sampling_freq = float(sampling_freq)
        self.relative_rate = Fraction(1, self.decim)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        self.declare_param("dphase", nco.freq_to_dphase(center_freq, sampling_freq),
                           dtype=None)
        self._dev_taps: dict[tuple, fir_ops.FirTaps] = {}

    def set_center_freq(self, f: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(f, self.sampling_freq))

    def init_state(self, nin, nout, device):
        return {"rot": analog_ops.rotator_init_state(),
                "fir": fir_ops.fir_init_state(len(self.taps), device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        key = (x.device, nout)
        if key not in self._dev_taps:
            self._dev_taps[key] = fir_ops.fir_taps(self.taps, nout, self.decim,
                                                   x.device)
        rot_st, xr = analog_ops.rotate(state["rot"], x, params["dphase"],
                                       conj=True)
        fir_st, y = fir_ops.fir_filter(self.taps, state["fir"], xr,
                                       decim=self.decim, method=self.method,
                                       dev_taps=self._dev_taps[key])
        return {"rot": rot_st, "fir": fir_st}, {"out": y}


class rational_resampler(Block):
    """Polyphase rational resampler interp/decim (reference
    filter::rational_resampler, upfirdn semantics). Designs its own taps if
    none given (low-pass at the min(1/interp, 1/decim) band edge)."""

    def __init__(self, interp: int, decim: int, taps=None, dtype="cf32",
                 name=None):
        super().__init__(name)
        self.interp = int(interp)
        self.decim = int(decim)
        if taps is None:
            cutoff = 0.45 / max(interp, decim)
            trans = 0.1 / max(interp, decim)
            taps = firdes.low_pass(interp, 1.0, cutoff, trans)
        self.taps = np.asarray(taps)
        self.relative_rate = Fraction(self.interp, self.decim)
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype)
        self.add_output("out", self.dtype)
        self._dev_taps: dict[tuple, object] = {}

    def init_state(self, nin, nout, device):
        return fir_ops.resampler_init_state(len(self.taps), self.interp, device,
                                            self.dtype.torch_dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"]
        key = (x.device, nout)
        if key not in self._dev_taps:
            self._dev_taps[key] = (
                fir_ops.fir_taps(self.taps, nout, self.decim, x.device)
                if self.interp == 1 else
                fir_ops.interp_taps(self.taps, self.interp, self.decim, x.device))
        st, y = fir_ops.fir_interp_filter(self.taps, state, x, self.interp,
                                          self.decim, dev_taps=self._dev_taps[key])
        return st, {"out": y}
