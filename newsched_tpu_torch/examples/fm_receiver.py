"""Broadcast-FM receive chain (config #1, the GR wfm_rcv shape; reference:
examples/fm_receiver.py):

    synthesized FM station -> freq_xlating_fir (tune + decimate)
        -> quadrature_demod -> rational_resampler -> fm_deemph -> sink

Synthesizes a 1 kHz tone FM-modulated onto a 200 kHz carrier at 1 MS/s,
demodulates it, and checks the recovered tone.
``python3 -m newsched_tpu_torch.examples.fm_receiver`` runs it on the card.
"""

import numpy as np

from newsched_tpu_torch.blocks import general
from newsched_tpu_torch.models import wbfm_receiver

FS = 1e6
CENTER = 200e3
TONE = 1e3
DEV = 75e3
N = 1 << 18


def synthesize_station():
    t = np.arange(N) / FS
    msg = np.sin(2 * np.pi * TONE * t)
    phase = 2 * np.pi * CENTER * t + 2 * np.pi * DEV * np.cumsum(msg) / FS
    return np.exp(1j * phase).astype(np.complex64)


def main(device="cuda"):
    iq = synthesize_station()
    fg, blocks = wbfm_receiver(
        fs=FS, center_freq=CENTER, deviation=DEV,
        source=general.vector_source(iq), batch_size=1 << 16,
        deemph_tau=75e-6)
    fg.run(device=device)
    audio = blocks["sink"].data()
    audio_rate = FS / 4 / 5  # quad decim 4, audio decim 5
    spec = np.abs(np.fft.rfft(audio[1000:] * np.hanning(len(audio) - 1000)))
    peak = np.argmax(spec) * audio_rate / (len(audio) - 1000)
    print(f"{len(audio)} audio samples @ {audio_rate:.0f} Hz; "
          f"dominant tone {peak:.1f} Hz (expected {TONE:.0f})")
    assert abs(peak - TONE) < 20


if __name__ == "__main__":
    main()
