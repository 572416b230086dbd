"""A mesh of logical shards (reference: newsched_tpu/parallel/mesh.py),
in one process or across processes.

The reference's mesh is a ``jax.sharding.Mesh`` of real devices (tested on
a simulated 8-device CPU mesh in one process). The port's is an
arrangement of logical shards with axis names, all on one torch device,
and, unlike the reference, it may hold more shards than there are
devices: one card holds all of them. That is the counterpart of
``--xla_force_host_platform_device_count``: a sharded graph runs each
shard's kernels with its own absolute stream position, and the
collectives (``parallel/halo.py``) are tensor operations between the
shards.

A ``ProcessMesh`` (``make_process_mesh``) is the counterpart of
``jax.distributed.initialize`` plus a mesh over the global devices (the
reference's ``tests/test_multihost.py``): ``world`` processes, joined by a
``torch.distributed`` process group over gloo, each owning ``n_local``
consecutive shards of the global time axis and feeding and holding only
those. Its exchanges (parallel/halo.py: the ring of each rank's last
rows, the channelizer's corner turn, a broadcast) go through host
memory, so every rank may run on the same card. Placing shards on cards of their own (and NCCL between them) is
later work (ROADMAP Queue 1, item 11); until then a mesh names the one
device where its process's shards run and where the graph's stream
edges and states live.
"""

from __future__ import annotations

import datetime

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

    # one process holds every shard
    rank, world = 0, 1

    def local(self, axis: str) -> int:
        """The shards of ``axis`` that this process holds."""
        return self.shape[axis]

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


class ProcessMesh(Mesh):
    """A 1-D mesh of ``shape[axis]`` global shards over ``world``
    processes of a process group: rank r holds global shards [r n_local,
    (r+1) n_local) on ``device``. ``staging`` keeps the pinned host
    buffers of its exchanges, one set per exchange and tensor shape, made
    once."""

    def __init__(self, device: torch.device, axis_name: str, n_shards: int,
                 rank: int, world: int, group):
        super().__init__(device, (axis_name,), (n_shards,))
        self.rank, self.world, self.group = int(rank), int(world), group
        self.n_local = self.shape[axis_name] // self.world
        self.staging: dict = {}

    def local(self, axis: str) -> int:
        return self.n_local

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self):
        return (f"ProcessMesh({self.shape}, rank {self.rank} of "
                f"{self.world}, on {self.device})")


def make_process_mesh(n_shards: int, axis_name: str = "t", *, rank: int,
                      world: int, init_method: str, backend: str = "gloo",
                      device=None, timeout_s: float = 120.0) -> ProcessMesh:
    """Join a process group of ``world`` processes as ``rank`` and return
    its mesh of ``n_shards`` global time shards, ``n_shards // world`` of
    them this process's. Every rank calls it with the same arguments but
    ``rank``, once a process. ``init_method``: where the ranks meet
    (``"file:///path"`` or ``"tcp://localhost:<port>"``). ``device``: the
    rank's device, by default ``cuda:(rank mod device_count)`` (every rank
    on the one card of a one-card machine); "cpu" for the tests. Raises
    where ``world`` does not divide ``n_shards``, for a backend other than
    gloo (NCCL between cards is ROADMAP Queue 1, item 11), without a card
    unless the CPU is asked for, and when a peer does not join within
    ``timeout_s`` (which also bounds every later exchange)."""
    import torch.distributed as dist

    if backend == "nccl":
        raise NotImplementedError(
            "make_process_mesh: NCCL between cards is not ported (ROADMAP "
            "Queue 1, item 11: it needs a second card); use backend='gloo'")
    if backend != "gloo":
        raise ValueError(f"make_process_mesh: backend {backend!r} is not "
                         f"'gloo'")
    n_shards, rank, world = int(n_shards), int(rank), int(world)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"make_process_mesh: rank {rank} of world {world}")
    if n_shards < 1 or n_shards % world:
        raise ValueError(f"make_process_mesh: world {world} does not divide "
                         f"the {n_shards} shards")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_process_mesh: no CUDA device is visible; pass "
                "device='cpu' for ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = _device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return ProcessMesh(device, axis_name, n_shards, rank, world,
                       dist.group.WORLD)
