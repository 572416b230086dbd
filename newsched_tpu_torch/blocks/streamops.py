"""Stream restructuring blocks (reference: newsched_tpu/blocks/
streamops.py): delay, skiphead, keep_one_in_n, keep_m_in_n, repeat,
interleave, deinterleave, stream_to_vector, streams_to_vector,
vector_to_streams, vector_to_stream.

All are static-shape reindexing; a few carry small state (the delay line,
skiphead's tail) or change rate (declared as Fractions, so the compiler
sizes batches)."""

from __future__ import annotations

from fractions import Fraction

import torch

from newsched_tpu_torch.runtime.block import Block, SyncBlock
from newsched_tpu_torch.utils.dtypes import port_dtype


class delay(SyncBlock):
    """Delay by d items, zeros first (reference streamops::delay)."""

    def __init__(self, d: int, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.d = int(d)
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def init_state(self, nin, nout, device):
        return {"line": torch.zeros((self.d,) + self.vlen,
                                    dtype=self.dtype.torch_dtype, device=device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        if self.d == 0:
            return state, {"out": x}
        full = torch.cat([state["line"], x])
        return {"line": full[-self.d:]}, {"out": full[: x.shape[0]]}


class skiphead(Block):
    """Drop the first n items, n arbitrary (reference streamops::skiphead).

    Advancing a stream needs lookahead, so the block emits the advanced
    stream with one batch of latency: with n = q*nin + r, the state carries
    the last nin-r items and y_b = [tail_{b-1}, x_b[:r]]. The concatenated
    output is zeros(nin-r) ++ x, and the declared ``lead_items`` of
    (q+1)*nout makes the sinks trim exactly x[:n] plus the startup zeros;
    ``finite_items`` lowers the stream's bound by n (the compiler's hooks,
    runtime/compile.py).
    """

    def __init__(self, n: int, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.n_skip = int(n)
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def finite_items(self, in_bound: int | None) -> int | None:
        return None if in_bound is None else max(in_bound - self.n_skip, 0)

    def lead_items(self, in_lead: int, nin: int, nout: int) -> int:
        if self.n_skip == 0:
            return in_lead
        q = self.n_skip // nin
        return in_lead + (q + 1) * nout

    def init_state(self, nin, nout, device):
        r = self.n_skip % nin
        return {"tail": torch.zeros((nin - r,) + self.vlen,
                                    dtype=self.dtype.torch_dtype, device=device)}

    def work(self, state, ins, params, nout):
        x = ins["in"]
        if self.n_skip == 0:
            return state, {"out": x}
        tail = state["tail"]
        r = x.shape[0] - tail.shape[0]  # n_skip % nin, from static shapes
        return {"tail": x[r:]}, {"out": torch.cat([tail, x[:r]])}


class keep_one_in_n(Block):
    """Output every n-th item, the last of each group of n (reference
    streamops::keep_one_in_n)."""

    def __init__(self, n: int, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.n = int(n)
        self.relative_rate = Fraction(1, self.n)
        self.add_input("in", dtype, vlen)
        self.add_output("out", dtype, vlen)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"][self.n - 1:: self.n]}


class keep_m_in_n(Block):
    """Keep m of every n items from ``offset`` (reference
    streamops::keep_m_in_n)."""

    def __init__(self, m: int, n: int, offset: int = 0, dtype="cf32",
                 name=None):
        super().__init__(name)
        self.m, self.n, self.offset = int(m), int(n), int(offset)
        if not 0 < self.m <= self.n or self.offset + self.m > self.n:
            raise ValueError("need 0 < m <= n and offset+m <= n")
        self.relative_rate = Fraction(self.m, self.n)
        # the per-batch input count must divide by n, beyond the (possibly
        # reduced) rate fraction
        self.in_multiple = self.n
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        groups = ins["in"].reshape(-1, self.n)
        return state, {"out": groups[:, self.offset: self.offset + self.m]
                       .reshape(-1)}


class repeat(Block):
    """Repeat each item n times (reference streamops::repeat)."""

    def __init__(self, n: int, dtype="cf32", name=None):
        super().__init__(name)
        self.n = int(n)
        self.relative_rate = Fraction(self.n, 1)
        self.add_input("in", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        return state, {"out": torch.repeat_interleave(ins["in"], self.n, 0)}


class interleave(Block):
    """N streams -> one stream, round-robin by blocksize items (reference
    streamops::interleave)."""

    def __init__(self, nstreams: int = 2, blocksize: int = 1, dtype="cf32",
                 name=None):
        super().__init__(name)
        self.nstreams, self.blocksize = int(nstreams), int(blocksize)
        self.relative_rate = Fraction(self.nstreams, 1)
        self.in_multiple = self.blocksize
        for k in range(self.nstreams):
            self.add_input(f"in{k}", dtype)
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        xs = [ins[f"in{k}"].reshape(-1, self.blocksize)
              for k in range(self.nstreams)]
        return state, {"out": torch.stack(xs, 1).reshape(-1)}


class deinterleave(Block):
    """One stream -> N streams, round-robin (reference
    streamops::deinterleave)."""

    def __init__(self, nstreams: int = 2, blocksize: int = 1, dtype="cf32",
                 name=None):
        super().__init__(name)
        self.nstreams, self.blocksize = int(nstreams), int(blocksize)
        self.relative_rate = Fraction(1, self.nstreams)
        self.in_multiple = self.nstreams * self.blocksize
        self.add_input("in", dtype)
        for k in range(self.nstreams):
            self.add_output(f"out{k}", dtype)

    def work(self, state, ins, params, nout):
        g = ins["in"].reshape(-1, self.nstreams, self.blocksize)
        return state, {f"out{k}": g[:, k, :].reshape(-1)
                       for k in range(self.nstreams)}


class stream_to_vector(Block):
    """Pack vlen scalars into one vector item (reference
    streamops::stream_to_vector)."""

    def __init__(self, vlen: int, dtype="cf32", name=None):
        super().__init__(name)
        self.vlen = int(vlen)
        self.relative_rate = Fraction(1, self.vlen)
        self.add_input("in", dtype)
        self.add_output("out", dtype, item_shape=(self.vlen,))

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].reshape(-1, self.vlen)}


class streams_to_vector(Block):
    """N parallel streams -> one stream of concatenated vector items, slot
    k from input k (reference streams_to_vector, itemsize-based: inputs of
    (v,) items give (nstreams*v,) items)."""

    def __init__(self, nstreams: int, dtype="cf32", vlen: int = 1, name=None):
        super().__init__(name)
        self.nstreams = int(nstreams)
        self.vlen = int(vlen)
        in_shape = () if self.vlen == 1 else (self.vlen,)
        for k in range(self.nstreams):
            self.add_input(f"in{k}", dtype, in_shape)
        self.add_output("out", dtype, item_shape=(self.nstreams * self.vlen,))

    def work(self, state, ins, params, nout):
        xs = [ins[f"in{k}"].reshape(nout, self.vlen)
              for k in range(self.nstreams)]
        return state, {"out": torch.cat(xs, 1)}


class vector_to_streams(Block):
    """One stream of concatenated vector items -> N parallel streams
    (reference streamops::vector_to_streams, itemsize-based: (v,) output
    items from (nstreams*v,) input items)."""

    def __init__(self, nstreams: int, dtype="cf32", vlen: int = 1, name=None):
        super().__init__(name)
        self.nstreams = int(nstreams)
        self.vlen = int(vlen)
        out_shape = () if self.vlen == 1 else (self.vlen,)
        self.add_input("in", dtype, item_shape=(self.nstreams * self.vlen,))
        for k in range(self.nstreams):
            self.add_output(f"out{k}", dtype, out_shape)

    def work(self, state, ins, params, nout):
        x = ins["in"]
        outs = {}
        for k in range(self.nstreams):
            seg = x[:, k * self.vlen: (k + 1) * self.vlen]
            outs[f"out{k}"] = seg[:, 0] if self.vlen == 1 else seg
        return state, outs


class vector_to_stream(Block):
    """Unpack vector items to scalars (reference
    streamops::vector_to_stream)."""

    def __init__(self, vlen: int, dtype="cf32", name=None):
        super().__init__(name)
        self.vlen = int(vlen)
        self.relative_rate = Fraction(self.vlen, 1)
        self.add_input("in", dtype, item_shape=(self.vlen,))
        self.add_output("out", dtype)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"].reshape(-1)}
