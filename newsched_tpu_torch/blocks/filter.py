"""Filter blocks (reference: newsched_tpu/blocks/filter.py): the streaming
FIR of config #0; the overlap-save fft_filter of config #3; the IIR and
the moving average; the polyphase channelizer and the single-channel
polyphase decimator; the frequency-translating FIR and the rational
resampler of the wideband-FM receiver."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from newsched_tpu_torch.ops import analog as analog_ops, fir as fir_ops, \
    firdes, iir as iir_ops, nco, pfb as pfb_ops
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype


_ENGINE_TIERS = {
    "xla": "the native transform pair, torch.fft (cuFFT on the card), FP32",
    "mxu": "the Bailey 128 x 128 fast convolution, FP32 matrix products",
}


def _dev_taps(blk, x: torch.Tensor, nout: int, method: str,
              fft_method: str = "auto", fft_size=None) -> fir_ops.FirTaps:
    """A FIR block's device constants for one device and batch shape,
    built once (``ops/fir.py`` ``fir_taps``). When fft_method "auto" picks
    the "fft" method's engine, and with it the accuracy tier, the block
    logs which one, once."""
    key = (x.device, nout)
    if key not in blk._dev_taps:
        dt = fir_ops.fir_taps(blk.taps, nout, blk.decim, x.device, method,
                              x.is_complex(), fft_method, fft_size)
        blk._dev_taps[key] = dt
        if dt.fft is not None and dt.fft.auto and not blk._engine_logged:
            blk._engine_logged = True
            blk.log.info("fft_method='auto' picked the %r engine: %s",
                         dt.fft.engine, _ENGINE_TIERS[dt.fft.engine])
    return blk._dev_taps[key]


class fir_filter(Block):
    """Streaming FIR, optional decimation (reference filter::fir_filter):
    dtype in == dtype out (cf32 or rf32), taps real or complex, ``method``
    as ``ops/fir.py`` ``fir_filter`` takes it ("mxu3", config #0's, is its
    FP32 Toeplitz path; "auto" takes "fft" above 384 taps). The taps'
    device constants are built once per device and batch shape."""

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
        self._engine_logged = False

    def init_state(self, nin, nout, device):
        return fir_ops.fir_init_state(len(self.taps), device,
                                      self.dtype.torch_dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"]
        st, y = fir_ops.fir_filter(self.taps, state, x, decim=self.decim,
                                   method=self.method,
                                   dev_taps=_dev_taps(self, x, nout,
                                                      self.method))
        return st, {"out": y}


class fft_filter(fir_filter):
    """Overlap-save fast-convolution FIR (reference filter::fft_filter):
    ``fir_filter`` with method "fft". ``fft_method`` selects the transform
    engine: "xla" (torch.fft, cuFFT on the card, FP32), "mxu" (the Bailey
    128 x 128 fast convolution, ops/fftops.py, FP32 matrix products) or
    "auto" (``ops/fir.py`` ``fft_engine``; logged once). ``fft_size`` is
    the segment's transform size (None: the reference's adaptive rule)."""

    def __init__(self, taps, decim: int = 1, dtype="cf32",
                 fft_size: int | None = None, fft_method: str = "auto",
                 name=None):
        if fft_method not in fir_ops.FFT_METHODS:
            raise ValueError(f"fft_method {fft_method!r} not in auto/xla/mxu")
        super().__init__(taps, decim, dtype, "fft", name)
        self.fft_size = fft_size
        self.fft_method = fft_method

    def work(self, state, ins, params, nout):
        x = ins["in"]
        dt = _dev_taps(self, x, nout, "fft", self.fft_method, self.fft_size)
        st, y = fir_ops.fir_filter(self.taps, state, x, decim=self.decim,
                                   method="fft", dev_taps=dt,
                                   fft_method=self.fft_method,
                                   fft_size=self.fft_size)
        return st, {"out": y}


class iir_filter(Block):
    """Streaming IIR (reference filter::iir_filter), ops/iir.py (S4 on the
    card, the chunked matrix form on the CPU); its constants, and on the
    card S4's workspace, built once per device and batch length."""

    def __init__(self, ff_taps, fb_taps, dtype="rf32", name=None):
        super().__init__(name)
        self.ff = np.asarray(ff_taps, dtype=np.float32)
        self.fb = np.asarray(fb_taps, dtype=np.float32)
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype)
        self.add_output("out", self.dtype)
        self._consts: dict[tuple, iir_ops.IirConsts] = {}

    def init_state(self, nin, nout, device):
        return iir_ops.iir_init_state(len(self.ff), len(self.fb), device,
                                      self.dtype.torch_dtype)

    def work(self, state, ins, params, nout):
        x = ins["in"]
        key = (x.device, nout)
        if key not in self._consts:
            self._consts[key] = iir_ops.iir_consts(self.ff, self.fb, nout,
                                                   x.device)
        st, y = iir_ops.iir_filter(self.ff, self.fb, state, x,
                                   consts=self._consts[key])
        return st, {"out": y}


class moving_average(fir_filter):
    """Length-N moving average with optional scale (reference
    filter::moving_average), as a FIR of N equal taps ("conv", as the
    reference)."""

    def __init__(self, length: int, scale: float | None = None, decim: int = 1,
                 dtype="rf32", name=None):
        self.length = int(length)
        scale = 1.0 / length if scale is None else scale
        super().__init__(np.full(length, scale, dtype=np.float32), decim, dtype,
                         "conv", name)


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
    centered at k/M of the input rate. At M = 64 P, P = 1 .. 7 it runs the
    fused front end kernel (K1 ``arm_fold_dft``) on a GPU, at any other M
    the fold kernel (K7 ``arm_fold``) and cuFFT's combine
    (``ops/pfb.py`` ``auto_method``)."""

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
        self._engine_logged = False

    def set_center_freq(self, f: float) -> None:
        self.set_param("dphase", nco.freq_to_dphase(f, self.sampling_freq))

    def init_state(self, nin, nout, device):
        return {"rot": analog_ops.rotator_init_state(device),
                "fir": fir_ops.fir_init_state(len(self.taps), device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        rot_st, xr = analog_ops.rotate(state["rot"], x, params["dphase"],
                                       conj=True)
        fir_st, y = fir_ops.fir_filter(self.taps, state["fir"], xr,
                                       decim=self.decim, method=self.method,
                                       dev_taps=_dev_taps(self, x, nout,
                                                          self.method))
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
                fir_ops.fir_taps(self.taps, nout, self.decim, x.device,
                                 complex_stream=x.is_complex())
                if self.interp == 1 else
                fir_ops.interp_taps(self.taps, self.interp, self.decim, x.device))
        st, y = fir_ops.fir_interp_filter(self.taps, state, x, self.interp,
                                          self.decim, dev_taps=self._dev_taps[key])
        return st, {"out": y}
