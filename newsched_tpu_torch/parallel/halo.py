"""The collectives between the logical shards of a mesh (reference:
newsched_tpu/parallel/halo.py ``time_halo``, and the ``lax.all_to_all``
of the reference's shard_map steps). The reference's one ``lax.psum``, of
the last shard's boundary rows (``wbfm_rcv_fused``), is that shard's value
itself here.

A process's shards (parallel/mesh.py) are a list of tensors, one per
shard in mesh order, and a collective between them is a tensor operation.
Slices are views: a halo is read where it lies, never copied. Across the
ranks of a process mesh, the one exchange is the ring of ``time_halo``:
each rank's last rows go to the next rank, in one non-blocking
send/receive pair a batch (``ring_exchange``), through pinned host memory
when the rows lie on a card (gloo moves host tensors).
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
    send, recv, done = stage_out(real, mesh)
    ring_swap(send, recv, done, mesh)
    out = stage_in(recv, real)
    return torch.view_as_complex(out) if tail.is_complex() else out


def stage_out(real: torch.Tensor, mesh):
    """The exchange's host pair for a real tensor: on the CPU the tensor
    itself and a new receive buffer; on a card the mesh's pinned (2,
    *shape) buffer for this shape, made once, its first half filled by a
    copy on the current stream, and the event that marks the copy's end."""
    if real.device.type == "cpu":
        return real.contiguous(), torch.empty_like(real), None
    key = (tuple(real.shape), real.dtype)
    if key not in mesh.staging:
        mesh.staging[key] = torch.empty((2, *real.shape), dtype=real.dtype,
                                        pin_memory=True)
    buf = mesh.staging[key]
    buf[0].copy_(real, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(real.device))
    return buf[0], buf[1], done


def ring_swap(send: torch.Tensor, recv: torch.Tensor, done, mesh) -> None:
    """The gloo half: once ``done`` (the copy into ``send``) has ended,
    send ``send`` to the next rank and receive the previous rank's into
    ``recv``; returns when both have completed (or raises at the group's
    timeout)."""
    import torch.distributed as dist

    if done is not None:
        done.synchronize()
    r, w = mesh.rank, mesh.world
    ops = [dist.P2POp(dist.isend, send, (r + 1) % w, mesh.group),
           dist.P2POp(dist.irecv, recv, (r - 1) % w, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def stage_in(recv: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The received rows on ``like``'s device: on a card a new tensor,
    copied from the pinned buffer on the current stream (the next
    exchange's ``stage_out`` event comes after it on that stream, so the
    buffer is not written again before the copy has read it)."""
    if like.device.type == "cpu":
        return recv
    return torch.empty_like(like).copy_(recv, non_blocking=True)


def all_to_all(xs: list, split_axis: int, concat_axis: int) -> list:
    """Tiled ``lax.all_to_all``: every shard cuts its value into n pieces
    along ``split_axis`` and shard j gathers piece j of every shard, in
    shard order, along ``concat_axis`` (the channelizer's corner turn)."""
    n = len(xs)
    pieces = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([p[j] for p in pieces], dim=concat_axis)
            for j in range(n)]
