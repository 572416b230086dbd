"""Mesh, collectives, the sharded channelizer and the sharded FIR (reference:
newsched_tpu/parallel): logical shards in one process, all on one device,
or a process mesh of ranks joined over gloo (parallel/mesh.py)."""

from newsched_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_process_mesh,
)
from newsched_tpu_torch.parallel.halo import time_halo  # noqa: F401
from newsched_tpu_torch.parallel.channelizer import (  # noqa: F401
    PlanesFMState,
    ShardedFMChannelizer,
    planes_rows,
)
from newsched_tpu_torch.parallel.sharded_fir import (  # noqa: F401
    ShardedFirFilter,
    ShardedFirState,
)
