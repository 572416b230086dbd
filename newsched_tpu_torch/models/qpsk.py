"""QPSK link models (reference: newsched_tpu/models/qpsk.py): a coherent
digital transceiver built from the digital block family.

- qpsk_tx        — symbols -> diff encode -> map -> RRC pulse shape @ sps
- qpsk_receiver  — samples -> AGC -> RRC matched filter -> M&M clock
                   recovery (S2) -> costas carrier recovery (S1) ->
                   constellation decode -> diff decode -> symbols

The diagonal QPSK constellation (psk(4, rot=pi/4)) makes the costas
loop's 4-fold phase ambiguity a +k (mod 4) index shift, which the
differential codec cancels. After loop settling the received symbols
equal the transmitted ones, delayed by the filters' lag, under a phase
offset within about +-0.4 rad, a fractional symbol timing offset and
moderate noise. The reference's docstring also claims carrier frequency
offset; measured on the reference, the receiver does not lock past about
0.4 rad of phase or under any frequency drift, since the M&M slicer runs
first and decides on unrotated axes. The port copies that behaviour.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.blocks import analog, digital, filter as filt, general
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.runtime.graph import Flowgraph


def qpsk_constellation() -> digital.Constellation:
    return digital.Constellation.psk(4, rot=np.pi / 4)


def rrc_taps(sps: int, excess_bw: float = 0.35, ntaps: int | None = None,
             gain: float | None = None) -> np.ndarray:
    if ntaps is None:
        ntaps = 11 * sps
    if gain is None:
        gain = float(sps)  # interpolating pulse shaper: unit symbol energy
    return firdes.root_raised_cosine(gain, float(sps), 1.0, excess_bw, ntaps)


def qpsk_tx(symbols, sps: int = 4, excess_bw: float = 0.35,
            batch_size: int | None = None):
    """Transmitter: ri32 symbol indices (0..3) -> cf32 baseband at sps
    samples/symbol, RRC pulse-shaped, differentially encoded."""
    const = qpsk_constellation()
    fg = Flowgraph("qpsk_tx", batch_size=batch_size)
    src = general.vector_source(np.asarray(symbols, np.int32), dtype="ri32")
    enc = digital.diff_encoder(4)
    mapper = digital.chunks_to_symbols(const)
    shaper = filt.rational_resampler(sps, 1, taps=rrc_taps(sps, excess_bw),
                                     dtype="cf32")
    snk = general.vector_sink(dtype="cf32")
    fg.connect(src, 0, enc, 0)
    fg.connect(enc, 0, mapper, 0)
    fg.connect(mapper, 0, shaper, 0)
    fg.connect(shaper, 0, snk, 0)
    return fg, {"src": src, "enc": enc, "mapper": mapper, "shaper": shaper,
                "sink": snk, "constellation": const}


def qpsk_receiver(samples=None, source=None, sps: int = 4,
                  excess_bw: float = 0.35, loop_bw: float = 0.06,
                  gain_mu: float = 0.1, batch_size: int | None = None):
    """Receiver: cf32 baseband at sps samples/symbol -> ri32 symbol indices.

    AGC -> RRC matched filter -> clock_recovery_mm(sps) -> costas_loop
    (order 4) -> constellation_decoder -> diff_decoder. ``source``
    replaces the vector source of ``samples``."""
    const = qpsk_constellation()
    fg = Flowgraph("qpsk_receiver", batch_size=batch_size)
    if source is None:
        source = general.vector_source(np.asarray(samples, np.complex64),
                                       dtype="cf32")
    agc = analog.agc(rate=1e-2, reference=1.0, dtype="cf32")
    # Matched filter: unit-gain RRC (TX shaper carried the sps gain).
    mf = filt.fir_filter(rrc_taps(sps, excess_bw, gain=1.0), dtype="cf32")
    timing = digital.clock_recovery_mm(sps, gain_mu=gain_mu)
    carrier = digital.costas_loop(loop_bw, order=4)
    decode = digital.constellation_decoder(const)
    dec = digital.diff_decoder(4)
    snk = general.vector_sink(dtype="ri32")
    fg.connect(source, 0, agc, 0)
    fg.connect(agc, 0, mf, 0)
    fg.connect(mf, 0, timing, 0)
    fg.connect(timing, 0, carrier, 0)
    fg.connect(carrier, 0, decode, 0)
    fg.connect(decode, 0, dec, 0)
    fg.connect(dec, 0, snk, 0)
    return fg, {"source": source, "agc": agc, "mf": mf, "timing": timing,
                "carrier": carrier, "decoder": decode, "diff": dec,
                "sink": snk, "constellation": const}
