"""Stream tags: metadata pinned to absolute item offsets (reference:
newsched_tpu/runtime/tags.py).

Tags travel as a fixed-capacity, mask-validated TagBatch beside each
batch, every field a tensor on the run's device, so a step that carries
tags has static shapes and no host round trip, and a captured CUDA graph
replays it:

  offsets: int32[K]  item offset RELATIVE to the batch start (absolute
                     offsets are rebuilt on the host as batch_index *
                     items_per_batch + offset)
  keys:    int32[K]  interned key ids (host-side registry)
  values:  f32[K,VP] small numeric payload (richer payloads live host-side,
                     keyed by a handle: the PayloadRegistry)
  valid:   bool[K]
  pids:    int32[K] or None, the rich payloads' handles

Rate remapping is exact integer arithmetic on offsets: offset' = offset *
num // den (the reference's decimator/interpolator tag placement).
``remap``, ``shift``, ``merge`` and ``compact`` read no tensor value on the
host: they are safe inside a captured step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

VALUE_DIM = 2


class TagBatch(NamedTuple):
    offsets: torch.Tensor  # int32[K]
    keys: torch.Tensor  # int32[K]
    values: torch.Tensor  # f32[K, VALUE_DIM]
    valid: torch.Tensor  # bool[K]
    # Rich-payload handle: 0 = none, else 1-based index into the host-side
    # PAYLOADS registry. Optional (None) so numeric-only tags pay nothing.
    pids: Any = None  # int32[K] | None

    @property
    def capacity(self) -> int:
        return self.offsets.shape[0]


def empty(capacity: int, device, with_pids: bool = False) -> TagBatch:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TagBatch(offsets=z(capacity), keys=z(capacity),
                    values=z(capacity, VALUE_DIM, dtype=torch.float32),
                    valid=z(capacity, dtype=torch.bool),
                    pids=z(capacity) if with_pids else None)


def remap(tags: TagBatch, num: int, den: int) -> TagBatch:
    """Rational offset remap across a rate change (out = in * num // den,
    in int64 so the product never overflows)."""
    if num == den:
        return tags
    off = torch.div(tags.offsets.to(torch.int64) * num, den,
                    rounding_mode="floor")
    return tags._replace(offsets=off.to(torch.int32))


def shift(tags: TagBatch, delta) -> TagBatch:
    return tags._replace(offsets=(tags.offsets + delta).to(torch.int32))


def _pids_of(t: TagBatch) -> torch.Tensor:
    return t.pids if t.pids is not None else torch.zeros_like(t.keys)


def merge(a: TagBatch, b: TagBatch) -> TagBatch:
    """Concatenate two tag batches (capacity grows; static)."""
    any_pids = a.pids is not None or b.pids is not None
    return TagBatch(
        offsets=torch.cat([a.offsets, b.offsets]),
        keys=torch.cat([a.keys, b.keys]),
        values=torch.cat([a.values, b.values]),
        valid=torch.cat([a.valid, b.valid]),
        pids=torch.cat([_pids_of(a), _pids_of(b)]) if any_pids else None,
    )


def compact(t: TagBatch, capacity: int):
    """Pack valid tags first, in stream order, and truncate to ``capacity``.

    Bounds the capacity snowballing of deep multi-input graphs (every
    all_to_all merge concatenates, so static capacities sum along paths).
    Returns (compacted TagBatch, n_dropped int32 0-dim tensor); drops occur
    only when more than ``capacity`` tags are valid at once. A stable sort
    on (invalid, offset) at the static capacity: the earliest valid tags
    survive whichever input port they came in by.
    """
    if t.capacity <= capacity:
        return t, torch.zeros((), dtype=torch.int32, device=t.offsets.device)
    key = torch.where(t.valid, t.offsets,
                      torch.full_like(t.offsets, torch.iinfo(torch.int32).max))
    take = torch.sort(key, stable=True).indices[:capacity]
    n_valid = t.valid.to(torch.int32).sum()
    dropped = torch.clamp(n_valid - capacity, min=0).to(torch.int32)
    return TagBatch(
        offsets=t.offsets[take], keys=t.keys[take], values=t.values[take],
        valid=t.valid[take], pids=None if t.pids is None else t.pids[take],
    ), dropped


class KeyRegistry:
    """Host-side interning of tag keys (the pmtf-symbol analog)."""

    def __init__(self):
        self._to_id: dict[str, int] = {}
        self._to_key: list[str] = []

    def intern(self, key: str) -> int:
        if key not in self._to_id:
            self._to_id[key] = len(self._to_key)
            self._to_key.append(key)
        return self._to_id[key]

    def name(self, kid: int) -> str:
        return self._to_key[kid]


REGISTRY = KeyRegistry()


class PayloadRegistry:
    """Host-side store of rich tag payloads (the pmtf-map analog): arbitrary
    Python objects keyed by the 1-based int handle the device carries in
    TagBatch.pids. Per process."""

    def __init__(self):
        self._items: list = []

    def add(self, obj) -> int:
        self._items.append(obj)
        return len(self._items)  # 1-based; 0 = no payload

    def get(self, pid: int):
        return self._items[pid - 1] if 0 < pid <= len(self._items) else None


PAYLOADS = PayloadRegistry()


class Tag(NamedTuple):
    """Host-side tag: absolute offset + key + numeric vector (+ optional
    rich payload, the pmtf-map analog)."""

    offset: int
    key: str
    value: tuple
    payload: Any = None


def decode_batches(stacked: TagBatch, items_per_batch: int,
                   registry: KeyRegistry = REGISTRY,
                   payloads: PayloadRegistry = PAYLOADS) -> list[Tag]:
    """Host: stacked per-batch TagBatch (leading n_batches axis; tensors or
    arrays) -> the absolute tags, sorted by offset."""
    offs = np.asarray(stacked.offsets)
    keys = np.asarray(stacked.keys)
    vals = np.asarray(stacked.values)
    valid = np.asarray(stacked.valid)
    pids = None if stacked.pids is None else np.asarray(stacked.pids)
    out: list[Tag] = []
    for b in range(offs.shape[0]):
        for i in np.nonzero(valid[b])[0]:
            payload = payloads.get(int(pids[b, i])) if pids is not None else None
            out.append(Tag(int(offs[b, i]) + b * items_per_batch,
                           registry.name(int(keys[b, i])),
                           tuple(float(v) for v in vals[b, i]),
                           payload))
    out.sort(key=lambda t: t.offset)
    return out
