"""A mesh of logical shards (reference: newsched_tpu/parallel/mesh.py).

The reference's mesh is a ``jax.sharding.Mesh`` of real devices (tested on
a simulated 8-device CPU mesh in one process). The port's is an
arrangement of logical shards with axis names, all on one torch device,
and, unlike the reference, it may hold more shards than there are
devices: one card holds all of them. That is the counterpart of
``--xla_force_host_platform_device_count``: a sharded graph runs each
shard's kernels with its own absolute stream position, and the
collectives (``parallel/halo.py``) are tensor operations between the
shards.

Placing shards on cards of their own (and NCCL between them) is later
work; until then a mesh names the one device where every shard's kernels
run and where the graph's stream edges and states live.
"""

from __future__ import annotations

import torch


class Mesh:
    """Logical shards on named axes, all on ``device``. ``shape`` maps each
    axis name to its size, as a JAX mesh's does."""

    def __init__(self, device: torch.device, axis_names: tuple[str, ...],
                 axis_sizes: tuple[int, ...]):
        if len(axis_names) != len(axis_sizes):
            raise ValueError(f"{len(axis_sizes)} sizes for axes {axis_names}")
        if any(int(s) < 1 for s in axis_sizes):
            raise ValueError(f"a mesh axis needs at least one shard, got "
                             f"{tuple(axis_sizes)}")
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(axis_names, axis_sizes)}

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self):
        return f"Mesh({self.shape}, on {self.device})"


def _device(device) -> torch.device:
    """The device the shards run on: the current card for None or "cuda",
    else the one named. Without a card, a card raises: a mesh never falls
    back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass device='cpu' for "
                "a mesh of shards on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, axis_name: str = "t",
              device=None) -> Mesh:
    """1-D mesh of ``n_devices`` logical shards on the time/stream axis
    ``axis_name``, all on ``device`` (the current card by default; "cpu"
    for the tests). ``n_devices`` defaults to the number of visible cards
    (1 on the CPU), as the reference's does; more shards than devices is
    allowed (see the module docstring)."""
    dev = _device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(dev, (axis_name,), (int(n_devices),))


def make_mesh_2d(shape: tuple[int, int], axis_names=("host", "chip"),
                 device=None) -> Mesh:
    """2-D mesh (host x chip) of logical shards on one device, as
    ``make_mesh``'s: put the time axis on "chip" and channel groups on
    "host", as the reference does."""
    return Mesh(_device(device), tuple(axis_names), tuple(shape))
