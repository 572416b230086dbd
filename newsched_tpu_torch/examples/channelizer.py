"""The flagship chain (config #2): 64-channel polyphase channelizer ->
per-channel FM demod -> per-channel audio FIR (reference:
examples/channelizer.py).

``python3 -m newsched_tpu_torch.examples.channelizer`` runs it on the
card; ``--mesh`` runs the SAME flowgraph sharded over a mesh of the
device's shards (``fg.run(mesh=...)``).
"""

import sys

import numpy as np

from newsched_tpu_torch.models import fm_channelizer

NCHANS = 64
N_OUT = 4096  # audio-rate vector samples to produce


def main(device="cuda", mesh: bool = False):
    fg, blocks = fm_channelizer(nchans=NCHANS, n_samples=N_OUT,
                                sink="vector", batch_size=1 << 17)
    if mesh:
        from newsched_tpu_torch.parallel import make_mesh

        m = make_mesh(device=device)
        print(f"running sharded over {m.shape['t']} shard(s)")
        fg.run(device=device, mesh=m)
    else:
        fg.run(device=device)
    audio = blocks["sink"].data()
    print(f"audio matrix {audio.shape} (time x {NCHANS} channels), "
          f"rms {float(np.sqrt(np.mean(audio**2))):.4f}")
    assert audio.shape == (N_OUT, NCHANS)


if __name__ == "__main__":
    main(mesh="--mesh" in sys.argv[1:])
