"""The LIVE flagship: the whole 64-channel FM channelizer chain as ONE
source kernel (K5) that makes its own Gaussian input a batch with a
counter-based PRNG (Philox), no replay buffer, no input traffic
(``models.fm_channelizer(source="live", fused=True)``; reference:
examples/live_flagship.py, whose TPU PRNG has no CPU form: here the same
source runs everywhere, its plain version on the CPU). Its audio FIR is
the model's default, 193 taps at these rates.

``python3 -m newsched_tpu_torch.examples.live_flagship`` runs it on the
card and prints the audio's statistics and a rough rate (compile and
first launches included; the bench's two-point fit gives the true one).
"""

import time

import numpy as np

from newsched_tpu_torch.models import fm_channelizer

NCHANS = 64
N_OUT = 2048  # audio-rate vector samples


def main(device="cuda"):
    fg, blocks = fm_channelizer(nchans=NCHANS, n_samples=N_OUT,
                                sink="vector", batch_size=1 << 18,
                                source="live", fused=True)
    t0 = time.perf_counter()
    fg.run(device=device)
    dt = time.perf_counter() - t0
    audio = blocks["sink"].data()
    assert audio.shape == (N_OUT, NCHANS) and np.isfinite(audio).all()
    wideband = N_OUT * NCHANS * 8  # audio_decim=8
    print(f"live flagship on {device}: {audio.shape} audio in {dt:.2f}s "
          f"(~{wideband / dt / 1e6:.0f} Msps incl. first launches)")
    print(f"audio rms per channel (first 8): "
          f"{np.sqrt(np.mean(audio**2, axis=0))[:8].round(3)}")


if __name__ == "__main__":
    main()
