"""General stream blocks (reference: newsched_tpu/blocks/general.py, itself
the reference's blocklib/blocks/): copy, head, null_source/sink,
nop/nop_source/nop_sink, vector_source/sink, throttle, load, fanout,
msg_forward.

As in the reference, this module doubles as the test-fixture library:
vector_source -> DUT -> vector_sink is the canonical QA pattern; null_*
measure throughput; head bounds streams; copy/nop exercise the runtime's
paths.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.runtime.block import Block, SyncBlock
from newsched_tpu_torch.utils.dtypes import port_dtype


class copy(SyncBlock):
    """Pass-through (reference blocklib/blocks/copy)."""

    def __init__(self, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"]}


class nop(copy):
    """Alias of copy at the graph level."""


class head(SyncBlock):
    """Let at most n items through, then end the stream (reference
    blocklib/blocks/head). The bound is consumed by the compiler (exact
    sink totals + batch count); work is identity."""

    def __init__(self, n: int, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.max_items = int(n)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def finite_items(self, in_bound: int | None) -> int:
        return self.max_items if in_bound is None else min(in_bound, self.max_items)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"]}


class null_source(Block):
    """Infinite zeros (reference blocklib/blocks/null_source)."""

    def __init__(self, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen)
        self.add_output("out", dtype, vlen)

    def init_state(self, nin, nout, device):
        # one batch of zeros on the run's device, emitted every batch
        return {"zeros": torch.zeros((nout,) + self.vlen,
                                     dtype=self.dtype.torch_dtype,
                                     device=device)}

    def work(self, state, ins, params, nout):
        return state, {"out": state["zeros"]}


class nop_source(null_source):
    pass


class null_sink(Block):
    """Discard, keeping a per-batch checksum so a run is backed by values
    computed from every output item (the reference's null_sink exists for
    exactly this throughput-measuring role)."""

    collect_is_stream = False  # per-batch checksum scalar, not stream items

    def __init__(self, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.add_input("in", dtype, vlen)
        self.checksum = None

    def work(self, state, ins, params, nout):
        x = ins["in"]
        if x.is_complex():
            c = torch.sum(x.real) + torch.sum(x.imag)
        else:
            c = torch.sum(x.to(torch.float32))
        return state, c.to(torch.float32)

    def combine_collected(self, acc, collected_host):
        """Fold per-batch checksums as they arrive, so an unbounded run
        holds O(1) host memory for this sink."""
        s = float(np.sum([np.sum(np.asarray(c)) for c in collected_host]))
        return s if acc is None else acc + s

    def finalize(self, collected, total):
        # the stacked per-batch checksums (bounded runs) or the float
        # folded by combine_collected (unbounded)
        self.checksum = float(np.sum(collected))


class nop_sink(null_sink):
    pass


class vector_source(Block):
    """Emit a fixed host vector, optionally repeating (reference
    blocklib/blocks/vector_source<T>). The data is copied to the run's
    device once, in init_state; the read position is an int64 tensor there
    too, so a batch is a gather from the device copy with no host round
    trip, and a captured step replays from the position the step before
    left. A repeating source whose data is exactly one batch emits the
    buffer itself, with no copy (the bench's replay form).

    ``tags``: (offset, key[, value...]) tuples at absolute stream offsets,
    as the reference takes them: numeric values ride the device tag plane
    (up to tags.VALUE_DIM of them), one non-numeric value (or several) is a
    rich payload kept on the host behind a handle. Each tag is emitted once,
    in the batch whose window holds its offset (a repeating source does not
    repeat its tags); the offsets, keys and values live on the device with
    the source's state, so tagging adds no host work to a step."""

    def __init__(self, data, repeat: bool = False, dtype=None, vlen=(),
                 tags=None, name=None):
        super().__init__(name)
        self.data = np.asarray(data)
        if dtype is None:
            dtype = self.data.dtype
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen) or self.data.shape[1:]
        self.repeat = repeat
        self._tags_in = list(tags or [])
        self.tag_aware = bool(self._tags_in)
        if self._tags_in:
            from newsched_tpu_torch.runtime import tags as tags_mod

            self.tag_capacity = len(self._tags_in)
            self._tag_offsets = np.asarray([int(t[0]) for t in self._tags_in],
                                           np.int64)
            self._tag_keys = np.asarray(
                [tags_mod.REGISTRY.intern(str(t[1])) for t in self._tags_in],
                np.int32)
            vals = np.zeros((len(self._tags_in), tags_mod.VALUE_DIM), np.float32)
            pids = np.zeros((len(self._tags_in),), np.int32)
            for i, t in enumerate(self._tags_in):
                extra = tuple(t[2:])
                numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                              for v in extra)
                if extra and not numeric:
                    obj = extra[0] if len(extra) == 1 else list(extra)
                    pids[i] = tags_mod.PAYLOADS.add(obj)
                else:
                    for j, v in enumerate(extra[:tags_mod.VALUE_DIM]):
                        vals[i, j] = float(v)
            self._tag_values = vals
            self._tag_pids = pids if pids.any() else None
        self.add_output("out", self.dtype, self.vlen)

    def finite_items(self, in_bound) -> int | None:
        return None if self.repeat else len(self.data)

    def init_state(self, nin, nout, device):
        n = len(self.data)
        if self.repeat:
            arr = self.data
        else:
            # Pad with zeros to a batch multiple so the final partial batch
            # is a plain slice; the runner's sink trimming drops the pad.
            pad = (-n) % nout
            arr = np.concatenate(
                [self.data, np.zeros((pad,) + self.data.shape[1:], self.data.dtype)]
            ) if pad else self.data
        data = torch.as_tensor(np.ascontiguousarray(arr, self.dtype.np_dtype),
                               device=device)
        st = {"data": data,
              "pos": torch.zeros((), dtype=torch.int64, device=device)}
        if self._tags_in:
            # the true batch start (pos stops at the last batch of a finite
            # source) and the tags themselves, on the device
            st["abs_pos"] = torch.zeros((), dtype=torch.int64, device=device)
            st["tags"] = {k: torch.as_tensor(v, device=device) for k, v in (
                ("offsets", self._tag_offsets), ("keys", self._tag_keys),
                ("values", self._tag_values), ("pids", self._tag_pids))
                if v is not None}
        return st

    def work(self, state, ins, params, nout, in_tags=None):
        data, pos = state["data"], state["pos"]
        n = int(data.shape[0])
        if self.repeat and len(self.data) == nout:
            # whole buffer per batch: emitted as-is, pos stays 0
            out, new_pos = data, pos
        else:
            idx = pos + torch.arange(nout, device=data.device)
            if self.repeat:
                n_data = len(self.data)
                out = data[idx % n_data]
                new_pos = (pos + nout) % n_data
            else:
                # the data is padded to whole batches, so a batch never
                # reads past the end; the position stops at the last batch
                out = data[idx]
                new_pos = torch.clamp(pos + nout, max=max(n - nout, 0))
        new_state = {**state, "pos": new_pos}
        if not self._tags_in:
            return new_state, {"out": out}
        from newsched_tpu_torch.runtime.tags import TagBatch

        start, t = state["abs_pos"], state["tags"]
        offs = t["offsets"]
        otags = TagBatch(offsets=(offs - start).to(torch.int32), keys=t["keys"],
                         values=t["values"],
                         valid=(offs >= start) & (offs < start + nout),
                         pids=t.get("pids"))
        new_state["abs_pos"] = start + nout
        return new_state, {"out": out}, otags


class vector_sink(Block):
    """Collect the stream (and its tags) into host memory (reference
    vector_sink<T> with its data() and tags() accessors).

    ``capacity``: under an UNBOUNDED stream (start()/stop()) the runner
    keeps only enough batches to cover the last ``capacity`` items, and
    data() is that trailing window (tag offsets relative to its start).
    Without one, the runner refuses this sink on an unbounded stream."""

    collects_tags = True

    def __init__(self, dtype="cf32", vlen=(), name=None,
                 capacity: int | None = None):
        super().__init__(name)
        self.add_input("in", dtype, vlen)
        self.collect_capacity = None if capacity is None else int(capacity)
        self._data: np.ndarray | None = None
        self._tags: list = []

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def finalize(self, collected, total):
        if isinstance(collected, dict):
            self._tags = collected["tags"]
            collected = collected["data"]
        arr = np.asarray(collected)
        arr = arr[:total] if total is not None else arr
        if self.collect_capacity is not None and total is None:
            arr = arr[-self.collect_capacity:]
        self._data = arr

    def data(self) -> np.ndarray:
        if self._data is None:
            raise RuntimeError(f"{self.name}: flowgraph has not run")
        return self._data

    def tags(self) -> list:
        return self._tags


class throttle(SyncBlock):
    """Pace the stream to items_per_sec on the host (reference
    blocklib/blocks/throttle): the runner sleeps between batches so that
    this block's stream runs no faster (a paced graph runs the step loop,
    not graph mode). A no-op on the device."""

    def __init__(self, items_per_sec: float, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.pacing = float(items_per_sec)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"]}


class load(SyncBlock):
    """Synthetic compute load: `iterations` fused multiply-adds per item
    (reference blocklib/blocks/load, for runtime overhead benchmarks)."""

    def __init__(self, iterations: int = 1, dtype="cf32", name=None):
        super().__init__(name)
        self.iterations = int(iterations)
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        y = ins["in"]
        for _ in range(self.iterations):
            y = y * 1.0000001 + 1e-9
        return state, {"out": y}


class fanout(SyncBlock):
    """1-to-N explicit fanout (reference bench graphs). Any output port may
    feed several edges, so fanout exists for parity with the reference's
    benchmark graphs."""

    def __init__(self, n: int = 2, dtype="cf32", name=None):
        super().__init__(name)
        self.add_input("in", dtype)
        for k in range(n):
            self.add_output(f"out{k}", dtype)

    def work(self, state, ins, params, nout):
        return state, {p.name: ins["in"] for p in self.outputs}


class msg_forward(Block):
    """Forward messages in -> out (reference blocklib/blocks/msg_forward);
    a host-side control-plane block for message tests."""

    def __init__(self, name=None):
        super().__init__(name)
        self.received: list = []
        self.add_msg_port_in("in", self._handle)
        self.add_msg_port_out("out")

    def _handle(self, msg):
        self.received.append(msg)
        self.post_msg("out", msg)

    def work(self, state, ins, params, nout):
        return state, None
