"""The collectives between the logical shards of a mesh (reference:
newsched_tpu/parallel/halo.py ``time_halo``, and the ``lax.all_to_all``
of the reference's shard_map steps). The reference's one ``lax.psum``, of
the last shard's boundary rows (``wbfm_rcv_fused``), is that shard's value
itself here.

Shards live in one process (parallel/mesh.py), so a value that the
reference holds per device is a list of tensors, one per shard in mesh
order, and a collective is a tensor operation between them. Slices are
views: a halo is read where it lies, never copied.
"""

from __future__ import annotations

import torch


def time_halo(segs: list, carries: list):
    """Each shard's left halo for its time segment, with the reference's
    ``ppermute`` semantics.

    Args:
      segs: shard i's (S, ...) time segment of the current batch.
      carries: shard i's (H, ...) carry from the previous batch; only
        shard 0's is read (the reference updates every device's to keep
        its SPMD shapes).

    Returns (halos, new_carries): shard i > 0's halo is the last H rows of
    shard i-1, shard 0's is its carry; new_carries[i] is what shard i
    received, so shard 0's new carry is the last shard's tail, the halo it
    needs next batch.
    """
    h = int(carries[0].shape[0])
    tails = [s[-h:] for s in segs]
    recv = tails[-1:] + tails[:-1]
    return [carries[0], *tails[:-1]], recv


def all_to_all(xs: list, split_axis: int, concat_axis: int) -> list:
    """Tiled ``lax.all_to_all``: every shard cuts its value into n pieces
    along ``split_axis`` and shard j gathers piece j of every shard, in
    shard order, along ``concat_axis`` (the channelizer's corner turn)."""
    n = len(xs)
    pieces = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([p[j] for p in pieces], dim=concat_axis)
            for j in range(n)]
