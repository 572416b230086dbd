"""Time-sharded streaming FIR / fft_filter with stream tags (reference:
newsched_tpu/parallel/sharded_fir.py), BASELINE config #3: overlap-save
fast convolution with the sample stream cut across the time shards of a
mesh and the stream tags surviving the shard boundaries.

Each shard filters its stretch of the batch after the halo exchange
(parallel/halo.py ``time_halo``): the overlap-save overlap is the halo.
Tags need no exchange: they are batch-relative and ride beside the
batch, and the shards' outputs join in time order, so a tag's offset maps
as offset * 1 // decim exactly as in the unsharded filter.

The shards are the port's logical shards (parallel/mesh.py), all on the
mesh's device: shard i's segment is a view of the batch, its halo a view
of shard i-1's segment, and the carry keeps the reference's layout, one
block of ntaps-1 samples per shard. On a process mesh each rank passes
its own stretch of the batch, holds the carry blocks of its own shards
and gets its own output; its first shard's halo comes over
``time_halo``'s ring from rank r-1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops import fir as fir_ops
from newsched_tpu_torch.parallel.halo import time_halo
from newsched_tpu_torch.runtime import tags as tags_mod


class ShardedFirState(NamedTuple):
    carry: torch.Tensor  # (shards * (ntaps-1),) input tail carry, per shard


class ShardedFirFilter:
    """step(x, tags, state) -> (y, tags', state): x (B,) the whole batch,
    cut into ``mesh.shape[axis]`` time shards (on a process mesh the
    rank's stretch, its ``mesh.local(axis)`` shards); tags a TagBatch or
    None; y (B/decim,)."""

    def __init__(self, mesh, taps: np.ndarray, decim: int = 1,
                 method: str = "fft", axis: str = "t"):
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.shape[axis]
        self.n_local = mesh.local(axis)  # the shards this process holds
        self.taps = np.asarray(taps)
        self.ntaps = len(self.taps)
        self.decim = int(decim)
        self.method = method
        self._dev_taps: dict[tuple, fir_ops.FirTaps] = {}

    def init_state(self) -> ShardedFirState:
        return ShardedFirState(carry=torch.zeros(
            (self.n_local * (self.ntaps - 1),), dtype=torch.complex64,
            device=self.mesh.device))

    def min_batch(self) -> int:
        """A shard's segment must cover the ntaps-1 halo and divide by
        decim."""
        seg = max(-(-(self.ntaps - 1) // self.decim) * self.decim, self.decim)
        return self.n_dev * seg

    def step(self, x: torch.Tensor, tags, state: ShardedFirState):
        B = int(x.shape[0])
        seg = B // self.n_local
        if B % (self.n_local * self.decim) != 0:
            raise ValueError(f"batch {B} must divide by n_dev*decim")
        if seg < self.ntaps - 1:
            raise ValueError(
                f"segment {seg} smaller than halo {self.ntaps - 1}; raise batch")
        key = (x.device, seg, x.is_complex())
        if key not in self._dev_taps:
            self._dev_taps[key] = fir_ops.fir_taps(
                self.taps, seg // self.decim, self.decim, x.device,
                self.method, x.is_complex())
        dt = self._dev_taps[key]
        H = self.ntaps - 1
        n = self.n_local
        segs = list(x.chunk(n))
        carries = list(state.carry.chunk(n)) if H else [x[:0]] * n
        if H:
            halos, new_carries = time_halo(segs, carries, self.mesh)
        else:
            halos, new_carries = carries, carries
        ys = [fir_ops.fir_filter(self.taps, fir_ops.FirState(tail=h), s,
                                 decim=self.decim, method=self.method,
                                 dev_taps=dt)[1]
              for s, h in zip(segs, halos)]
        out_tags = None if tags is None else tags_mod.remap(tags, 1, self.decim)
        carry = torch.cat(new_carries).to(state.carry.dtype) if H else state.carry
        return torch.cat(ys), out_tags, ShardedFirState(carry=carry)
