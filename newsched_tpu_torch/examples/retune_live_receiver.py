"""Retune a RUNNING fused wbfm receiver over the authenticated control
socket (reference: examples/retune_live_receiver.py):

  - the fused wbfm receive chain (xlate -> demod -> resampler as ONE
    kernel, K10) running as a partition;
  - ``center_freq``, a FENCE parameter: the remote set_param rebuilds the
    rotated taps, and the runner applies them at the next batch boundary
    (runtime/block.py ParamSpec.fence);
  - the control plane with HMAC-SHA256 frames and the replay guard
    (runtime/control.py): an unkeyed client is refused BEFORE its pickle
    is ever deserialized.

A two-tone input carries stations at 231.25 kHz and 331.25 kHz; the
receiver starts tuned near the first, and once the audio partition holds
its first batch (no sleep decides when) a RuntimeClient retunes it near
the second; the audio shows the re-lock.
``python3 -m newsched_tpu_torch.examples.retune_live_receiver`` runs it on
the card.
"""

import numpy as np

from newsched_tpu_torch.blocks import analog, general
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.runtime.control import RuntimeClient
from newsched_tpu_torch.runtime.distributed import (Runtime, edge_address,
                                                    partition_flowgraph)
from newsched_tpu_torch.runtime.graph import Flowgraph

FS = 1e6
F1, F2 = 231_250.0, 331_250.0
DEV = 75e3
BATCH = 61_440
N_BATCHES = 16
KEY = b"retune-demo-key"
WAIT_S = 120.0  # the longest the first batch may take


def main(device="cuda"):
    n = BATCH * N_BATCHES
    t = np.arange(BATCH * 4) / FS
    x = (np.exp(2j * np.pi * F1 * t)
         + np.exp(2j * np.pi * F2 * t)).astype(np.complex64)

    fg = Flowgraph(batch_size=BATCH)
    src = general.vector_source(x, repeat=True)
    thr = general.throttle(n / 1.0)  # ~1 s of stream to retune in
    rcv = analog.wbfm_rcv_fused(
        firdes.low_pass(1.0, FS, 100e3, 30e3), center_freq=200e3, fs=FS,
        decim=4, deviation=DEV, resamp_decim=5, name="rcv0")
    hd = general.head(n // 20, dtype="rf32")
    snk = general.vector_sink(dtype="rf32")
    fg.connect(src, 0, thr, 0)
    fg.connect(thr, 0, rcv, 0)
    fg.connect(rcv, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)

    parts = partition_flowgraph(fg, {"radio": [src, thr, rcv, hd],
                                     "audio": [snk]})
    edge = next(b for b in parts["audio"].blocks if b.name.startswith("xfer_in"))
    addr = edge_address()
    rt = Runtime(parts, total_items={"radio": n, "audio": n // 20},
                 control_addresses={"radio": addr}, control_auth_key=KEY,
                 device=device)
    rt.start()

    rogue = RuntimeClient(addr, timeout_ms=5000)  # no key
    try:
        rogue.ping()
        raise SystemExit("the unkeyed client should have been refused")
    except RuntimeError as e:
        print(f"unauthenticated client refused: {e}")
    rogue.close()

    ctl = RuntimeClient(addr, auth_key=KEY)
    ctl.ping()
    first = edge.first_batch.wait(WAIT_S)
    assert first, "the audio partition received no batch"
    print(f"tuned to {float(ctl.get_param('rcv0', 'center_freq')) / 1e3:.1f}"
          f" kHz; retuning to 290 kHz mid-stream...")
    ctl.set_param("rcv0", "center_freq", 290e3)  # a fence parameter
    rt.wait()
    ctl.close()

    audio = np.asarray(snk.data())
    a1 = (F1 - 200e3) / DEV   # the audio's constant while tuned to 200 kHz
    a2 = (F2 - 290e3) / DEV   # after the retune (0.55, distinct)
    near1 = np.abs(audio - a1) < 2e-2
    near2 = np.abs(audio - a2) < 2e-2
    print(f"audio: {len(audio)} samples; {int(near1.sum())} locked to "
          f"station 1 ({a1:+.3f}), {int(near2.sum())} to station 2 "
          f"({a2:+.3f}) after the retune")
    assert near2[-1] and near2.sum() > len(audio) // 20, "retune failed"
    assert near1.sum() > len(audio) // 20, "no pre-retune region"
    print("OK: running fused receiver retuned over the authed socket")


if __name__ == "__main__":
    main()
