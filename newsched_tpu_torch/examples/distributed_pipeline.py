"""One logical flowgraph split across two runtimes with a ZMQ stream edge
(the reference's distributed runtime: graph_utils::partition +
buffer_net_zmq + runtime_monitor; examples/distributed_pipeline.py). Tags
emitted in partition "head" arrive at the sink in partition "tail" with
exact offsets. The edge is the port's own ZMTP (``io/zmtp.py``).
``python3 -m newsched_tpu_torch.examples.distributed_pipeline`` runs both
partitions on the card.
"""

import numpy as np

from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general, math as gmath
from newsched_tpu_torch.runtime.distributed import Runtime, partition_flowgraph


def main(device="cuda"):
    data = (np.arange(4096) % 17).astype(np.complex64)
    fg = Flowgraph(batch_size=1024)
    src = general.vector_source(data, tags=[(0, "start"), (4000, "near_end")])
    cp = general.copy()
    mc = gmath.multiply_const(3.0 + 0j, "cf32")
    snk = general.vector_sink()
    fg.connect(src, 0, cp, 0)
    fg.connect(cp, 0, mc, 0)
    fg.connect(mc, 0, snk, 0)

    parts = partition_flowgraph(fg, {"head": [src, cp], "tail": [mc, snk]})
    rt = Runtime(parts, total_items={"tail": len(data)}, device=device)
    rt.run()

    np.testing.assert_allclose(snk.data(), data * 3.0, rtol=1e-6)
    tags = [(t.offset, t.key) for t in snk.tags()]
    print(f"{len(snk.data())} items through the zmq edge; tags {tags}")
    assert tags == [(0, "start"), (4000, "near_end")]


if __name__ == "__main__":
    main()
