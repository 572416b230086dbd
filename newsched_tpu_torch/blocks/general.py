"""General stream blocks (reference: newsched_tpu/blocks/general.py, itself
the reference's blocklib/blocks/): head, null_sink, vector_source and
vector_sink — the blocks the fused flagship flowgraph and its tests use.

As in the reference, this module doubles as the test-fixture library:
vector_source -> DUT -> vector_sink is the canonical QA pattern; null_sink
measures throughput; head bounds streams.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.runtime.block import Block, SyncBlock
from newsched_tpu_torch.utils.dtypes import port_dtype


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

    def finalize(self, collected, total):
        self.checksum = float(np.sum(collected))


class vector_source(Block):
    """Emit a fixed host vector, optionally repeating (reference
    blocklib/blocks/vector_source<T>). The data is copied to the run's
    device once, in init_state; the read position is an int64 tensor there
    too, so a batch is a gather from the device copy with no host round
    trip, and a captured step replays from the position the step before
    left. A repeating source whose data is exactly one batch emits the
    buffer itself, with no copy (the bench's replay form)."""

    def __init__(self, data, repeat: bool = False, dtype=None, vlen=(),
                 name=None):
        super().__init__(name)
        self.data = np.asarray(data)
        if dtype is None:
            dtype = self.data.dtype
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen) or self.data.shape[1:]
        self.repeat = repeat
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
        return {"data": data,
                "pos": torch.zeros((), dtype=torch.int64, device=device)}

    def work(self, state, ins, params, nout):
        data, pos = state["data"], state["pos"]
        n = int(data.shape[0])
        if self.repeat and len(self.data) == nout:
            # whole buffer per batch: emitted as-is, pos stays 0
            return state, {"out": data}
        idx = pos + torch.arange(nout, device=data.device)
        if self.repeat:
            n_data = len(self.data)
            out = data[idx % n_data]
            new_pos = (pos + nout) % n_data
        else:
            # the data is padded to whole batches, so a batch never reads
            # past the end; the position stops at the last batch
            out = data[idx]
            new_pos = torch.clamp(pos + nout, max=max(n - nout, 0))
        return {"data": data, "pos": new_pos}, {"out": out}


class vector_sink(Block):
    """Collect the stream into host memory (reference vector_sink<T> with
    its data() accessor)."""

    def __init__(self, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.add_input("in", dtype, vlen)
        self._data: np.ndarray | None = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def finalize(self, collected, total):
        arr = np.asarray(collected)
        self._data = arr[:total] if total is not None else arr

    def data(self) -> np.ndarray:
        if self._data is None:
            raise RuntimeError(f"{self.name}: flowgraph has not run")
        return self._data
