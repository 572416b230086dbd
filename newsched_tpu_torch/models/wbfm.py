"""Flagship models (reference: newsched_tpu/models/wbfm.py).

- fm_channelizer — configs #2/#4: pfb_channelizer -> per-channel FM demod
                   -> per-channel audio FIR decimation, in its fused form.

Returns (Flowgraph, dict of interesting blocks), as in the reference.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.blocks import general, vector_dsp
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.runtime.graph import Flowgraph


def fm_channelizer(nchans: int = 64, fs: float = 100e6, taps_per_arm: int = 16,
                   audio_decim: int = 8, n_samples: int | None = None,
                   source=None, batch_size: int | None = None, sink: str = "null",
                   deviation_frac: float = 0.3, fused: bool = False,
                   precision="split3", audio_taps=None):
    """Configs #2/#4: wideband channelizer + per-channel FM demod + per-
    channel audio decimating FIR. The headline benchmark chain.

    Input: one wideband stream at fs. Output: (nchans,)-vector rf32 audio
    stream at fs / nchans / audio_decim.

    fused=True runs the whole chain as the single fused-kernel block on the
    planes-rows stream (vector_dsp.fm_channelizer_fused_planes): a cf32
    ``source`` gets a cplx_to_planes adapter; with no source, a
    noise_planes_source feeds the kernel its native format directly. A
    source with an (2*nchans,)-vector rf32 output port is used as a planes
    source as-is. n_samples bounds the OUTPUT stream (audio
    (nchans,)-vector items, the head block's units); batch_size is wideband
    samples.

    Not ported yet: fused=False (the staged graph, next slice) and
    source="live" (the generating fused source, after it).
    """
    if not fused:
        raise NotImplementedError(
            "fm_channelizer(fused=False): the staged graph (pfb_channelizer "
            "-> vector_quad_demod -> vector_fir) is the next slice of the port")
    if isinstance(source, str) and source == "live":
        raise NotImplementedError(
            "fm_channelizer(source='live'): the generating fused source "
            "(fm_noise_channelizer_source, kernel fm_chain_gen_step) comes "
            "after the staged slice")
    chan_rate = fs / nchans
    if audio_taps is None:
        audio_taps = firdes.low_pass(1.0, chan_rate, 0.4 * chan_rate / audio_decim,
                                     0.1 * chan_rate / audio_decim)
    fused_blk = vector_dsp.fm_channelizer_fused_planes(
        nchans, None, audio_taps, audio_decim=audio_decim,
        gain=1.0 / (2 * np.pi * deviation_frac), taps_per_arm=taps_per_arm,
        precision=precision)
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
    snk = (general.null_sink(dtype="rf32", vlen=(nchans,)) if sink == "null"
           else general.vector_sink(dtype="rf32", vlen=(nchans,)))
    if n_samples is not None:
        hd = general.head(n_samples, dtype="rf32", vlen=(nchans,))
        fg.connect(fused_blk, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
    else:
        fg.connect(fused_blk, 0, snk, 0)
    return fg, {
        "source": source, "adapter": adapter, "fused": fused_blk, "sink": snk,
        "audio_taps": audio_taps,
    }
