"""Mesh, collectives and the sharded channelizer (reference:
newsched_tpu/parallel): logical shards in one process, all on one device
(parallel/mesh.py)."""

from newsched_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from newsched_tpu_torch.parallel.halo import time_halo  # noqa: F401
from newsched_tpu_torch.parallel.channelizer import (  # noqa: F401
    PlanesFMState,
    ShardedFMChannelizer,
    planes_rows,
)
