"""The collectives between the logical shards of a mesh (reference:
newsched_tpu/parallel/halo.py ``time_halo``, and the ``lax.all_to_all``
of the reference's shard_map steps). The reference's one ``lax.psum``, of
the last shard's boundary rows (``wbfm_rcv_fused``), is that shard's value
itself here.

A process's shards (parallel/mesh.py) are a list of tensors, one per
shard in mesh order, and a collective between them is a tensor operation.
Slices are views: a halo is read where it lies, never copied. Across the
ranks of a process mesh there are three exchanges, each one gloo call a
batch: the ring of ``time_halo`` (each rank's last rows to the next rank,
``ring_exchange``), the corner turn of ``all_to_all`` (one
``all_to_all_single``, ``corner_exchange``) and ``broadcast`` (one rank's
rows to every rank, the counterpart of that ``psum``). gloo moves host
tensors, so rows that lie on a card pass through pinned host buffers
that the mesh keeps, one pair per exchange and shape, made once; the
copies run on the current stream and an event orders each gloo call
after them.
"""

from __future__ import annotations

import torch


def time_halo(segs: list, carries: list, mesh=None):
    """Each shard's left halo for its time segment, with the reference's
    ``ppermute`` semantics.

    Args:
      segs: shard i's (S, ...) time segment of the current batch (this
        process's shards, in order).
      carries: shard i's (H, ...) carry from the previous batch; only
        global shard 0's is read (the reference updates every device's to
        keep its SPMD shapes).
      mesh: a process mesh of more than one rank (parallel/mesh.py
        ``make_process_mesh``); None, or any mesh of one process, for
        shards that are all here.

    Returns (halos, new_carries): shard i > 0's halo is the last H rows of
    shard i-1, global shard 0's is its carry; new_carries[i] is what shard
    i received, so global shard 0's new carry is the last shard's tail,
    the halo it needs next batch. Across ranks a rank's first shard
    receives rank r-1's last H rows (rank 0's: the last rank's), in one
    exchange a call; every rank calls it once a batch.
    """
    h = int(carries[0].shape[0])
    tails = [s[-h:] for s in segs]
    if mesh is None or mesh.world == 1:
        recv = tails[-1:] + tails[:-1]
        return [carries[0], *tails[:-1]], recv
    got = ring_exchange(tails[-1], mesh)
    first = carries[0] if mesh.rank == 0 else got
    return [first, *tails[:-1]], [got, *tails[:-1]]


def ring_exchange(tail: torch.Tensor, mesh) -> torch.Tensor:
    """Send ``tail`` to rank (r+1) % world of the process mesh and return
    what rank (r-1) % world sent, a new tensor on ``tail``'s device. One
    ``batch_isend_irecv`` pair, so the ring cannot deadlock. On a card the
    rows pass through the pinned pair ``stage_out`` fills, the copies on
    the current stream: ``stage_out``, ``ring_swap``, ``stage_in``."""
    real = torch.view_as_real(tail) if tail.is_complex() else tail
    send, recv = stage_out(real, mesh)
    ring_swap(send, recv, real, mesh)
    out = stage_in(recv, real)
    return torch.view_as_complex(out) if tail.is_complex() else out


def stage_out(real: torch.Tensor, mesh):
    """The exchange's host pair for a real tensor: on the CPU the tensor
    itself and a new receive buffer; on a card the mesh's pinned pair for
    this shape, made once, the first filled by a copy on the current
    stream."""
    if real.device.type == "cpu":
        return real.contiguous(), torch.empty_like(real)
    send, recv = _pinned(mesh, "ring", real.shape, real.dtype, 2)
    send.copy_(real, non_blocking=True)
    return send, recv


def ring_swap(send: torch.Tensor, recv: torch.Tensor, like: torch.Tensor,
              mesh) -> None:
    """The gloo half: once the current stream's copies on ``like``'s
    device have ended, send ``send`` to the next rank and receive the
    previous rank's into ``recv``; returns when both have completed (or
    raises at the group's timeout)."""
    import torch.distributed as dist

    _after_stream(like)
    r, w = mesh.rank, mesh.world
    ops = [dist.P2POp(dist.isend, send, (r + 1) % w, mesh.group),
           dist.P2POp(dist.irecv, recv, (r - 1) % w, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def stage_in(recv: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The received rows on ``like``'s device: on a card a new tensor,
    copied from the pinned buffer on the current stream (the next
    exchange's ``ring_swap`` waits for that stream, so gloo does not
    write the buffer again before the copy has read it)."""
    if like.device.type == "cpu":
        return recv
    return torch.empty_like(like).copy_(recv, non_blocking=True)


def _pinned(mesh, key, shape, dtype, n: int = 1):
    """The mesh's ``n`` pinned host buffers of ``shape`` for ``key``, made
    at the first call."""
    key = (key, tuple(shape), dtype)
    if key not in mesh.staging:
        mesh.staging[key] = [torch.empty(tuple(shape), dtype=dtype,
                                         pin_memory=True) for _ in range(n)]
    return mesh.staging[key]


def _after_stream(t: torch.Tensor) -> None:
    """On a card, return once the current stream's work so far has ended
    (the copies into a pinned buffer, and the copies out of one that a
    gloo call is about to overwrite)."""
    if t.device.type != "cpu":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()


def broadcast(t: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of the process mesh, a new tensor
    on ``t``'s device (``t``'s value is read on ``src`` only): one gloo
    ``broadcast``, through a pinned buffer on a card."""
    import torch.distributed as dist

    real = torch.view_as_real(t) if t.is_complex() else t
    if real.device.type == "cpu":
        buf = real.clone(memory_format=torch.contiguous_format)
    else:
        buf, = _pinned(mesh, "broadcast", real.shape, real.dtype)
        if mesh.rank == src:
            buf.copy_(real, non_blocking=True)
    _after_stream(real)
    dist.broadcast(buf, src, group=mesh.group)
    out = buf if real.device.type == "cpu" else torch.empty_like(real).copy_(
        buf, non_blocking=True)
    return torch.view_as_complex(out) if t.is_complex() else out


def all_to_all(xs: list, split_axis: int, concat_axis: int,
               mesh=None) -> list:
    """Tiled ``lax.all_to_all``: every shard cuts its value into N pieces
    along ``split_axis`` (N the global shard count) and shard j gathers
    piece j of every shard, in shard order, along ``concat_axis`` (the
    channelizer's corner turn). ``xs``: this process's shards' values, in
    order. On a process mesh of more than one rank, rank r's shards are
    global shards [r n, (r+1) n) (n = len(xs)): it returns what they
    gather, the pieces of the other ranks' shards moved in one
    ``all_to_all_single`` (``corner_exchange``)."""
    if mesh is None or mesh.world == 1:
        n = len(xs)
        pieces = [torch.chunk(x, n, dim=split_axis) for x in xs]
        return [torch.cat([p[j] for p in pieces], dim=concat_axis)
                for j in range(n)]
    n, w = len(xs), mesh.world
    X = torch.stack(xs)
    ax = split_axis % (X.dim() - 1) + 1
    if X.shape[ax] % (n * w):
        raise ValueError(f"all_to_all: {X.shape[ax]} along axis {split_axis} "
                         f"do not split into {n * w} pieces")
    # T[q, j, i]: piece q n + j of local shard i, the pieces for rank q
    T = X.unflatten(ax, (w, n, X.shape[ax] // (n * w))).movedim(
        (ax, ax + 1), (0, 1))
    # G[p, j, i]: piece r n + j of rank p's shard i
    G = corner_exchange(T, mesh)
    k = concat_axis % (X.dim() - 1)
    return [G[:, j].flatten(0, 1).movedim(0, k).flatten(k, k + 1)
            for j in range(n)]


def corner_exchange(T: torch.Tensor, mesh) -> torch.Tensor:
    """The corner turn's exchange: ``T[q]`` (q over the world) goes to
    rank q; returns G, a new tensor like T on its device, G[p] what rank p
    sent this rank (G[r] = T[r]). On a card the other ranks' parts pass
    through the pinned pair ``corner_out`` fills: ``corner_out``,
    ``corner_swap``, ``corner_in``."""
    real = torch.view_as_real(T) if T.is_complex() else T
    send, recv = corner_out(real, mesh)
    corner_swap(send, recv, real, mesh)
    out = corner_in(recv, real, mesh)
    return torch.view_as_complex(out) if T.is_complex() else out


def corner_out(real: torch.Tensor, mesh):
    """The corner turn's host pair for a real (world, ...) tensor: the
    parts for the other ranks, in rank order, in a send buffer of (world
    - 1, ...), and a receive buffer like it. On the CPU new tensors; on a
    card the mesh's pinned pair for this shape, made once, the send
    buffer filled by copies on the current stream."""
    r = mesh.rank
    if real.device.type == "cpu":
        send = torch.cat([real[:r], real[r + 1:]])
        return send, torch.empty_like(send)
    send, recv = _pinned(mesh, "corner", (mesh.world - 1, *real.shape[1:]),
                         real.dtype, 2)
    send[:r].copy_(real[:r], non_blocking=True)
    send[r:].copy_(real[r + 1:], non_blocking=True)
    return send, recv


def corner_swap(send: torch.Tensor, recv: torch.Tensor, like: torch.Tensor,
                mesh) -> None:
    """The gloo half: once the current stream's copies on ``like``'s
    device have ended, one ``all_to_all_single`` sends ``send``'s part q
    to rank q and receives rank p's into ``recv``'s part p, nothing to
    this rank itself; returns when it has completed (or raises at the
    group's timeout)."""
    import torch.distributed as dist

    _after_stream(like)
    sizes = [int(q != mesh.rank) for q in range(mesh.world)]
    dist.all_to_all_single(recv, send, sizes, sizes, group=mesh.group)


def corner_in(recv: torch.Tensor, real: torch.Tensor, mesh) -> torch.Tensor:
    """G on ``real``'s device: this rank's own part from ``real``, the
    others' from ``recv`` (on a card copies on the current stream, which
    the next exchange's ``corner_swap`` waits for before gloo writes the
    buffer again)."""
    r = mesh.rank
    G = torch.empty_like(real)
    G[r] = real[r]
    G[:r].copy_(recv[:r], non_blocking=True)
    G[r + 1:].copy_(recv[r:], non_blocking=True)
    return G
