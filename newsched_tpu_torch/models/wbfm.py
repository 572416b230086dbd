"""Flagship models (reference: newsched_tpu/models/wbfm.py).

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


def _connect_out(fg, last, nchans: int, n_samples, snk) -> None:
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32", vlen=(nchans,))
        fg.connect(last, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(last, 0, snk, 0)


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
        _connect_out(fg, audio, nchans, n_samples, snk)
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
        _connect_out(fg, src, nchans, n_samples, snk)
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
    _connect_out(fg, fused_blk, nchans, n_samples, snk)
    return fg, {
        "source": source, "adapter": adapter, "fused": fused_blk, "sink": snk,
        "audio_taps": audio_taps,
    }
