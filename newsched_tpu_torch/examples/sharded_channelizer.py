"""Config #4's sharded flagship: the fused FM-channelizer kernel (K3) run
PER TIME SHARD of a mesh, each shard's halo rows taken from its
neighbour and its state rebuilt by warm-up rows, every shard of a batch
in one launch, the audio kept in time order (reference:
examples/sharded_channelizer.py).

The port's mesh is logical shards on one device (``parallel/mesh.py``), so
this runs on one card, or here on the CPU. It checks the sharded output
against the unsharded staged flowgraph (pfb_channelizer ->
vector_quad_demod -> vector_fir) to > 100 dB. The reference runs 32
channels; K3 takes M = 64 P channels, so this runs 64.
``python3 -m newsched_tpu_torch.examples.sharded_channelizer`` runs it on
the card.
"""

import numpy as np
import torch

from newsched_tpu_torch.blocks import general
from newsched_tpu_torch.models import fm_channelizer
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.parallel import ShardedFMChannelizer, make_mesh, \
    planes_rows

M, DECIM, N_DEV, TAPS_PER_ARM = 64, 4, 8, 8
GAIN = 0.8


def main(device="cuda"):
    audio_taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    n_rows = N_DEV * 256          # planes rows per batch (= rows of M samples)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(2 * n_rows * M)
         + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64) * 0.5

    # the unsharded staged reference, at the same taps and gain
    ref_fg, ref = fm_channelizer(
        nchans=M, taps_per_arm=TAPS_PER_ARM, audio_decim=DECIM,
        audio_taps=audio_taps, deviation_frac=1 / (2 * np.pi * GAIN),
        source=general.vector_source(x), sink="vector",
        batch_size=n_rows * M)
    ref_fg.run(device=device)

    ch = ShardedFMChannelizer(make_mesh(N_DEV, device=device), M,
                              ref["pfb"].taps, audio_taps, audio_decim=DECIM,
                              demod_gain=GAIN)
    rows = torch.from_numpy(planes_rows(x, M)).to(device)
    state = ch.init_state_planes(n_rows)
    outs = []
    for b in range(2):
        audio, state = ch.step_planes(rows[b * n_rows:(b + 1) * n_rows], state)
        outs.append(audio.cpu().numpy())
    audio = np.concatenate(outs, axis=0)

    want = ref["sink"].data().astype(np.float64)
    err = audio.astype(np.float64) - want
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean(err ** 2), 1e-300))
    print(f"sharded fused audio {audio.shape} over {N_DEV} shards; SNR vs "
          f"the unsharded staged flowgraph: {snr:.1f} dB")
    assert snr > 100, snr


if __name__ == "__main__":
    main()
