"""Flagship models (reference: newsched_tpu/models/wbfm.py).

- fir_chain      — config #0: sig_source -> 128-tap FIR lowpass -> head,
                   staged or live.
- wbfm_receiver  — config #1: freq_xlating_fir -> quadrature_demod ->
                   rational_resampler (broadcast-FM receive chain), staged,
                   fused, or live.
- fm_channelizer — configs #2/#4: pfb_channelizer -> per-channel FM demod
                   -> per-channel audio FIR decimation, staged, fused, or
                   live.

Returns (Flowgraph, dict of interesting blocks), as in the reference.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.blocks import analog, filter as filt, general, vector_dsp
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.runtime.graph import Flowgraph


def _sink(nchans: int, sink: str):
    return (general.null_sink(dtype="rf32", vlen=(nchans,)) if sink == "null"
            else general.vector_sink(dtype="rf32", vlen=(nchans,)))


def _connect_out(fg, last, vlen, n_samples, snk) -> None:
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32", vlen=vlen)
        fg.connect(last, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(last, 0, snk, 0)


def _deemph(fg, last, tau, audio_rate):
    """analog.fm_deemph(audio_rate, tau) after ``last``, or None for no
    tau."""
    if tau is None:
        return None
    blk = analog.fm_deemph(audio_rate, tau=tau)
    fg.connect(last, 0, blk, 0)
    return blk


def fir_chain(n_samples: int = 10_000_000, fs: float = 1e6, ntaps: int = 128,
              frequency: float = 123_456.0, batch_size: int | None = None,
              sink: str = "null", source=None):
    """Config #0: signal_source -> FIR lowpass(ntaps) -> head -> sink.

    The staged graph (the default) is sig_source (K8) -> fir_filter with
    the reference's method "mxu3" (here the FP32 Toeplitz product) -> head.
    source="live" runs the whole chain as ONE kernel
    (analog.fir_tone_source, K9): the fixed-point NCO tone generated and
    filtered in the same pass, stateless but for the phase counter; equal
    to the staged chain to float32 accuracy (the same NCO values, the same
    taps)."""
    taps = firdes.low_pass(1.0, fs, 0.2 * fs, 0.05 * fs, ntaps=ntaps)
    fg = Flowgraph("fir_chain", batch_size=batch_size)
    snk = general.null_sink() if sink == "null" else general.vector_sink()
    hd = general.head(n_samples)
    if isinstance(source, str) and source == "live":
        src = analog.fir_tone_source(fs, taps, frequency=frequency)
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        return fg, {"src": src, "fir": src, "head": hd, "sink": snk,
                    "taps": taps}
    src = analog.sig_source(fs, "complex", frequency=frequency)
    fir = filt.fir_filter(taps, method="mxu3")
    fg.connect(src, 0, fir, 0)
    fg.connect(fir, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, {"src": src, "fir": fir, "head": hd, "sink": snk, "taps": taps}


def wbfm_receiver(fs: float = 1_000_000.0, center_freq: float = 200_000.0,
                  quad_rate_decim: int = 4, audio_decim: tuple[int, int] = (1, 5),
                  deviation: float = 75_000.0, n_samples: int | None = None,
                  source=None, batch_size: int | None = None, sink: str = "vector",
                  deemph_tau: float | None = None, fused: bool = False,
                  precision="split3"):
    """Config #1: wideband FM receiver, 1 MS/s -> 250 kS/s quad -> 50 kS/s
    audio by default.

    fused=False (the default) is the staged graph: ``source`` (a cf32
    stream; with none, a 0 Hz complex sig_source) -> freq_xlating_fir
    (channel select, decimate to the quad rate) -> quadrature_demod ->
    rational_resampler (audio rate).

    fused=True runs the whole chain as ONE kernel (analog.wbfm_rcv_fused,
    K10; interp-1 resampling, batches in multiples of 64*decim*
    resamp_decim samples): a cf32 source is folded in the block; a source
    whose output items are folded rows (rf32[(128,)], e.g.
    analog.sig_source_folded, K11) feeds the block's folded input directly.
    source="live" is the generating source (analog.wbfm_live_source, K12): a
    tone at center_freq, no input stream at all.

    n_samples bounds the OUTPUT (audio) stream; batch_size is input samples.
    deemph_tau (e.g. 75e-6, the GR wfm_rcv's de-emphasis; off by default,
    as config #1) appends analog.fm_deemph at the audio rate on every form.
    """
    quad_rate = fs / quad_rate_decim
    audio_rate = quad_rate * audio_decim[0] / audio_decim[1]
    chan_taps = firdes.low_pass(1.0, fs, 100e3, 30e3)
    interp, decim = audio_decim
    live = isinstance(source, str) and source == "live"
    if live and not fused:
        raise ValueError("source='live' requires fused=True")
    snk = (general.vector_sink(dtype="rf32") if sink == "vector"
           else general.null_sink(dtype="rf32"))
    kw = dict(decim=quad_rate_decim, deviation=deviation, resamp_interp=interp,
              resamp_decim=decim, precision=precision)
    if live:
        # the graph's reference item is an audio item of the source
        bsz = (None if batch_size is None
               else max(batch_size // (quad_rate_decim * decim), 1))
        fg = Flowgraph("wbfm_receiver", batch_size=bsz)
        src = analog.wbfm_live_source(chan_taps, center_freq, fs,
                                      frequency=center_freq, **kw)
        deemph = _deemph(fg, src, deemph_tau, audio_rate)
        _connect_out(fg, deemph or src, (), n_samples, snk)
        return fg, {"source": src, "fused": src, "xlate": src, "demod": src,
                    "resamp": src, "deemph": deemph, "sink": snk}
    if source is None:
        source = analog.sig_source(fs, "complex", frequency=0.0)
    if fused:
        folded = any(p.item_shape == (128,)
                     for p in getattr(source, "outputs", []))
        bsz = batch_size
        if folded and batch_size is not None:
            bsz = max(batch_size // 64, 1)  # a folded row is 64 samples
        fg = Flowgraph("wbfm_receiver", batch_size=bsz)
        blk = analog.wbfm_rcv_fused(
            chan_taps, center_freq, fs,
            input_format="folded" if folded else "cf32", **kw)
        fg.connect(source, 0, blk, 0)
        deemph = _deemph(fg, blk, deemph_tau, audio_rate)
        _connect_out(fg, deemph or blk, (), n_samples, snk)
        return fg, {"source": source, "fused": blk, "xlate": blk,
                    "demod": blk, "resamp": blk, "deemph": deemph, "sink": snk}
    fg = Flowgraph("wbfm_receiver", batch_size=batch_size)
    xlate = filt.freq_xlating_fir(chan_taps, center_freq, fs,
                                  decim=quad_rate_decim)
    demod = analog.quadrature_demod(gain=quad_rate / (2 * np.pi * deviation))
    resamp = filt.rational_resampler(interp, decim, dtype="rf32")
    fg.connect(source, 0, xlate, 0)
    fg.connect(xlate, 0, demod, 0)
    fg.connect(demod, 0, resamp, 0)
    deemph = _deemph(fg, resamp, deemph_tau, audio_rate)
    _connect_out(fg, deemph or resamp, (), n_samples, snk)
    return fg, {"source": source, "xlate": xlate, "demod": demod,
                "resamp": resamp, "deemph": deemph, "sink": snk}


def make_fm_demod_hier(quad_rate: float, deviation: float = 75e3,
                       audio_interp: int = 1, audio_decim: int = 5):
    """FM demod as a reusable HierBlock (reference: hier_block composites
    like GR's wfm_rcv): quadrature_demod -> rational_resampler, exported
    as one block with ports in=cf32, out=rf32."""
    from newsched_tpu_torch.runtime.graph import HierBlock

    class FmDemod(HierBlock):
        def __init__(self, name=None):
            super().__init__(name)
            demod = analog.quadrature_demod(
                gain=quad_rate / (2 * np.pi * deviation))
            resamp = filt.rational_resampler(audio_interp, audio_decim,
                                             dtype="rf32")
            self.graph.connect(demod, 0, resamp, 0)
            self.map_input("in", demod.i())
            self.map_output("out", resamp.o())

    return FmDemod()


def fm_channelizer(nchans: int = 64, fs: float = 100e6, taps_per_arm: int = 16,
                   audio_decim: int = 8, n_samples: int | None = None,
                   source=None, batch_size: int | None = None, sink: str = "null",
                   deviation_frac: float = 0.3, fused: bool = False,
                   precision="split3", audio_taps=None, noise_draws: int = 3):
    """Configs #2/#4: wideband channelizer + per-channel FM demod + per-
    channel audio decimating FIR. The headline benchmark chain.

    Input: one wideband stream at fs. Output: (nchans,)-vector rf32 audio
    stream at fs / nchans / audio_decim.

    fused=False (the default) is the staged graph: ``source`` (a cf32
    stream; with none, a gaussian noise_source at amplitude 0.5) ->
    pfb_channelizer -> vector_quad_demod -> vector_fir.

    fused=True runs the whole chain as the single fused-kernel block on the
    planes-rows stream (vector_dsp.fm_channelizer_fused_planes): a cf32
    ``source`` gets a cplx_to_planes adapter; with no source, a
    noise_planes_source feeds the kernel its native format directly. A
    source with an (2*nchans,)-vector rf32 output port is used as a planes
    source as-is. source="live" is the generating fused source
    (vector_dsp.fm_noise_channelizer_source, amplitude 0.5, seed 0, with
    ``noise_draws`` Philox words per sample): no input stream at all.

    n_samples bounds the OUTPUT stream (audio (nchans,)-vector items, the
    head block's units); batch_size is wideband samples.
    """
    chan_rate = fs / nchans
    if audio_taps is None:
        audio_taps = firdes.low_pass(1.0, chan_rate, 0.4 * chan_rate / audio_decim,
                                     0.1 * chan_rate / audio_decim)
    gain = 1.0 / (2 * np.pi * deviation_frac)
    if not fused:
        fg = Flowgraph("fm_channelizer", batch_size=batch_size)
        if source is None:
            source = analog.noise_source("gaussian", amplitude=0.5)
        pfb = filt.pfb_channelizer(nchans, taps_per_arm=taps_per_arm)
        demod = vector_dsp.vector_quad_demod(nchans, gain=gain)
        audio = vector_dsp.vector_fir(nchans, audio_taps, decim=audio_decim,
                                      dtype="rf32")
        snk = _sink(nchans, sink)
        fg.connect(source, 0, pfb, 0)
        fg.connect(pfb, 0, demod, 0)
        fg.connect(demod, 0, audio, 0)
        _connect_out(fg, audio, (nchans,), n_samples, snk)
        return fg, {"source": source, "pfb": pfb, "demod": demod,
                    "audio": audio, "sink": snk, "audio_taps": audio_taps}
    if isinstance(source, str) and source == "live":
        src = vector_dsp.fm_noise_channelizer_source(
            nchans, None, audio_taps, audio_decim=audio_decim, gain=gain,
            amplitude=0.5, seed=0, taps_per_arm=taps_per_arm,
            precision=precision, noise_draws=noise_draws)
        bsz = None if batch_size is None else \
            max(batch_size // (nchans * audio_decim), 1)
        fg = Flowgraph("fm_channelizer_live", batch_size=bsz)
        snk = _sink(nchans, sink)
        _connect_out(fg, src, (nchans,), n_samples, snk)
        return fg, {"source": src, "adapter": None, "fused": src,
                    "sink": snk, "audio_taps": audio_taps}
    fused_blk = vector_dsp.fm_channelizer_fused_planes(
        nchans, None, audio_taps, audio_decim=audio_decim, gain=gain,
        taps_per_arm=taps_per_arm, precision=precision)
    adapter = None
    if source is None:
        source = vector_dsp.noise_planes_source(nchans, amplitude=0.5)
    planes_native = any(
        p.item_shape == (2 * nchans,) for p in getattr(source, "outputs", []))
    # Planes-native source: the graph's reference item is a ROW (= nchans
    # wideband samples), so scale the requested batch accordingly.
    bsz = None
    if batch_size is not None:
        bsz = (max(batch_size // nchans, 1) if planes_native else batch_size)
    fg = Flowgraph("fm_channelizer_fused", batch_size=bsz)
    if planes_native:
        fg.connect(source, 0, fused_blk, 0)
    else:
        adapter = vector_dsp.cplx_to_planes(nchans)
        fg.connect(source, 0, adapter, 0)
        fg.connect(adapter, 0, fused_blk, 0)
    snk = _sink(nchans, sink)
    _connect_out(fg, fused_blk, (nchans,), n_samples, snk)
    return fg, {
        "source": source, "adapter": adapter, "fused": fused_blk, "sink": snk,
        "audio_taps": audio_taps,
    }
