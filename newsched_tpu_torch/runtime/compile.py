"""Flowgraph compiler: rate algebra + the per-batch step function
(reference: newsched_tpu/runtime/compile.py).

The reference scheduler's windowing, rate matching and buffer sizing are
solved once, statically:

  1. Rational rate propagation assigns every block an items-per-reference-
     item Fraction.
  2. A batch size N is chosen as the smallest multiple of the LCM of all
     rate denominators >= the requested size, so every edge carries a
     compile-time-fixed integer item count.
  3. Finite-stream bounds (head blocks, finite sources) propagate through
     the same algebra to give exact per-sink totals and the batch count.
  4. ``build_step`` emits the per-batch function (states, params) ->
     (states, sink_outputs) that the runner calls once per batch.

Steps 1-3 are the reference's code unchanged (pure Python).

Under a mesh of logical shards (parallel/mesh.py) the same graph compiles
to a sharded step: the batch is a multiple of the time axis, a block that
defines ``work_sharded`` (and ``init_state_sharded``) runs its own
per-shard formulation, and every other block runs on the whole-batch
tensor, which computes what the reference's SPMD partitioner computes.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Callable

from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.runtime.graph import Graph
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("compile")

DEFAULT_BATCH = 1 << 16


@dataclasses.dataclass
class CompiledFlowgraph:
    graph: Graph
    order: list[Block]
    rates: dict[str, Fraction]  # block name -> output rate (items/ref item)
    batch_ref: int  # N: reference items per batch
    n_in: dict[str, int]  # per-block input items per batch
    n_out: dict[str, int]  # per-block output items per batch
    bounds: dict[str, int | None]  # per-block total output items (None = inf)
    leads: dict[str, int]  # per-block leading garbage items at output
    n_batches: int | None  # None if unbounded
    sink_totals: dict[str, int | None]  # sink block name -> total input items
    sink_leads: dict[str, int]  # sink block name -> leading items to drop
    step: Callable[[dict, dict], tuple[dict, dict]]
    mesh: Any = None  # parallel.mesh.Mesh the step shards over (None: one)
    time_axis: str | None = None

    def init_states(self, device) -> dict[str, Any]:
        """Each block's initial state on ``device``; under a mesh whose
        time axis is > 1 (the size ``build_step`` selects ``work_sharded``
        by), a block's ``init_state_sharded`` where it has one."""
        n_time = self.mesh.shape[self.time_axis] if self.mesh is not None else 1
        out: dict[str, Any] = {}
        for b in self.order:
            nin, nout = self.n_in[b.name], self.n_out[b.name]
            if n_time > 1 and hasattr(b, "init_state_sharded"):
                out[b.name] = b.init_state_sharded(nin, nout, self.mesh,
                                                   self.time_axis)
            else:
                out[b.name] = b.init_state(nin, nout, device)
        return out

    def init_params(self, device) -> dict[str, Any]:
        return {b.name: b.param_leaves(device) for b in self.order}


def _port_ratio(b: Block, port: str) -> Fraction:
    """Items consumed on `port` per item on the block's base (ratio-1) input
    port. Declared via ``in_port_ratios`` (reference: the forecast machinery
    permitted arbitrary per-port ratios, SURVEY.md §3.1 work_io row)."""
    ratios = getattr(b, "in_port_ratios", None)
    return Fraction(ratios.get(port, 1)) if ratios else Fraction(1)


def _in_base_rate(g: Graph, b: Block, rates: dict[str, Fraction]) -> Fraction:
    """The block's base input rate: each input edge must carry
    base * ratio(port) items/ref-item."""
    bases = {}
    for e in g.in_edges(b):
        bases[e.dst_port] = rates[e.src.name] / _port_ratio(b, e.dst_port)
    uniq = set(bases.values())
    if len(uniq) != 1:
        raise ValueError(
            f"{b.name}: input rate mismatch {sorted(bases.items())} — each "
            "input must run at base_rate * in_port_ratios[port] (default "
            "ratio 1, i.e. all inputs at one rate)"
        )
    return uniq.pop()


def _propagate_rates(g: Graph, order: list[Block]) -> dict[str, Fraction]:
    rates: dict[str, Fraction] = {}
    for b in order:
        ins = g.in_edges(b)
        if not ins:
            rates[b.name] = Fraction(b.relative_rate)
            continue
        rates[b.name] = _in_base_rate(g, b, rates) * Fraction(b.relative_rate)
    return rates


def _choose_batch(rates: dict[str, Fraction], requested: int | None,
                  shard_n: int = 1, extra_lcm: int = 1) -> int:
    from newsched_tpu_torch.utils import prefs

    lcm = int(extra_lcm)
    for r in rates.values():
        lcm = lcm * r.denominator // math.gcd(lcm, r.denominator)
        # also keep numerators' contribution: n_out must be integer for
        # every block, which the denominator LCM guarantees.
    # Under a mesh, every edge's per-batch item count should divide evenly
    # across the time axis: N % (den_i * shard_n) == 0 makes n_out_i a
    # multiple of shard_n for every block.
    lcm *= shard_n
    target = requested or int(prefs.get("default_batch_size", DEFAULT_BATCH))
    n = max(1, -(-target // lcm)) * lcm
    return n


def _propagate_bounds(
    g: Graph, order: list[Block], rates: dict[str, Fraction]
) -> dict[str, int | None]:
    """Total output items each block will ever produce (None = unbounded).

    A block's own limit comes from block.finite_items(in_bound): head
    returns min(in_bound, max_items); finite sources return len(data);
    default scales the tightest input bound by the rate ratio.
    """
    bounds: dict[str, int | None] = {}
    for b in order:
        in_bound = _in_base_bound(g, b, bounds)
        limit = getattr(b, "finite_items", None)
        if limit is not None:
            own = limit(in_bound)
        elif in_bound is None:
            own = None
        else:
            rr = Fraction(b.relative_rate)
            own = int(in_bound * rr)
        bounds[b.name] = own
    return bounds


def compile_flowgraph(g: Graph, batch_size: int | None = None,
                      total_items: int | None = None, mesh=None,
                      time_axis: str | None = None) -> CompiledFlowgraph:
    """batch_size: requested items/batch at the reference rate (rate-1 source).
    total_items: override stream length at the reference rate (else derived
    from head blocks / finite sources; None with no bound = unbounded).
    mesh: a parallel.mesh.Mesh; the step shards over ``time_axis`` (default
    the mesh's first axis)."""
    order = g.topo_order()
    rates = _propagate_rates(g, order)
    shard_n = 1
    if mesh is not None:
        time_axis = time_axis or mesh.axis_names[0]
        shard_n = mesh.shape[time_axis]
    # Grouping constraints the rate fraction alone cannot carry
    # (reference: output_multiple/forecast, SURVEY.md §4.3): a block may
    # declare ``in_multiple`` — its per-batch input count must divide by
    # it (e.g. keep_m_in_n groups of n even though m/n reduces;
    # interleave blocksize). Fold each into the batch LCM at the block's
    # input rate: need (r.num * N) / r.den divisible by m.
    extra = 1
    for b in order:
        m = int(getattr(b, "in_multiple", 1))
        if m > 1 and g.in_edges(b):
            r = _in_base_rate(g, b, rates)
            need = (m * r.denominator) // math.gcd(r.numerator,
                                                   m * r.denominator)
            extra = extra * need // math.gcd(extra, need)
    N = _choose_batch(rates, batch_size, shard_n, extra)
    n_in: dict[str, int] = {}
    n_out: dict[str, int] = {}
    for b in order:
        ins = g.in_edges(b)
        # n_in is in BASE-port items (ports with a declared ratio consume
        # ratio * n_in items per batch; their edge counts carry that).
        n_in[b.name] = int(_in_base_rate(g, b, rates) * N) if ins else 0
        r = rates[b.name] * N
        if r.denominator != 1:
            raise AssertionError(f"non-integer batch for {b.name}: {r}")
        n_out[b.name] = int(r)

    bounds = _propagate_bounds(g, order, rates)
    if total_items is not None:
        for b in order:
            if not g.in_edges(b):
                cap = int(total_items * rates[b.name])
                bounds[b.name] = cap if bounds[b.name] is None else min(bounds[b.name], cap)
        # re-propagate downstream of the capped sources
        bounds = _merge_bounds(g, order, rates, bounds)

    # Leading-garbage propagation (blocks with lookahead latency, e.g.
    # skiphead, declare lead_items; default scales by the rate ratio).
    leads: dict[str, int] = {}
    for b in order:
        ins = g.in_edges(b)
        in_lead = max((int(Fraction(leads[e.src.name]) / _port_ratio(b, e.dst_port))
                       for e in ins), default=0)
        fn = getattr(b, "lead_items", None)
        if fn is not None:
            leads[b.name] = fn(in_lead, n_in[b.name], n_out[b.name])
        else:
            lr = in_lead * Fraction(b.relative_rate)
            if lr.denominator != 1:
                raise ValueError(f"{b.name}: lead items {lr} not integral at this rate")
            leads[b.name] = int(lr)

    sinks = [b for b in order if not b.outputs]
    sink_totals: dict[str, int | None] = {}
    sink_leads: dict[str, int] = {}
    n_batches: int | None = None
    for s in sinks:
        ins = g.in_edges(s)
        t = None
        for e in ins:
            sb = bounds[e.src.name]
            if sb is not None:
                t = sb if t is None else min(t, sb)
        sink_totals[s.name] = t
        sink_leads[s.name] = max((leads[e.src.name] for e in ins), default=0)
        if t is not None and n_in[s.name] > 0:
            nb = -(-(t + sink_leads[s.name]) // n_in[s.name])
            n_batches = nb if n_batches is None else max(n_batches, nb)

    step = build_step(g, order, n_out, n_in, mesh=mesh, time_axis=time_axis)
    return CompiledFlowgraph(
        graph=g,
        order=order,
        rates=rates,
        batch_ref=N,
        n_in=n_in,
        n_out=n_out,
        bounds=bounds,
        leads=leads,
        n_batches=n_batches,
        sink_totals=sink_totals,
        sink_leads=sink_leads,
        step=step,
        mesh=mesh,
        time_axis=time_axis,
    )


def _in_base_bound(g: Graph, b: Block, bounds: dict) -> int | None:
    """Tightest input bound expressed in base-port items (per-port ratios
    normalize each edge's total)."""
    in_bound = None
    for e in g.in_edges(b):
        x = bounds[e.src.name]
        if x is None:
            continue
        x = int(Fraction(x) / _port_ratio(b, e.dst_port))
        in_bound = x if in_bound is None else min(in_bound, x)
    return in_bound


def _merge_bounds(g, order, rates, seeded):
    bounds = dict(seeded)
    for b in order:
        ins = g.in_edges(b)
        if not ins:
            continue
        in_bound = _in_base_bound(g, b, bounds)
        limit = getattr(b, "finite_items", None)
        if limit is not None:
            own = limit(in_bound)
        elif in_bound is None:
            own = bounds[b.name]
        else:
            own = int(in_bound * Fraction(b.relative_rate))
            if bounds[b.name] is not None:
                own = min(own, bounds[b.name])
        bounds[b.name] = own
    return bounds

def build_step(g: Graph, order: list[Block], n_out: dict[str, int],
               n_in: dict[str, int] | None = None, mesh=None,
               time_axis: str | None = None):
    """Emit the per-batch function. Sinks (no stream outputs) return a
    per-batch collected value under their name (None to collect nothing).

    Under a mesh whose time axis is > 1, a block exposing ``work_sharded``
    runs its own per-shard formulation (the reference's explicit-collective
    lowering hook); every other block runs ``work`` on the whole batch.

    The tag plane (the reference's shadow TagBatch per edge) belongs to a
    later slice of the port: a graph whose sources declare a tag capacity,
    or that holds a tag-aware block, is refused here."""
    for b in order:
        if int(getattr(b, "tag_capacity", 0)) or getattr(b, "tag_aware", False):
            raise NotImplementedError(
                f"{b.name}: stream tags are not ported yet (the tag plane, "
                "runtime/tags.py, is ROADMAP Queue 1 item 4)")

    n_shard, axis = 1, None
    if mesh is not None and mesh.size > 1:
        axis = time_axis or mesh.axis_names[0]
        n_shard = mesh.shape[axis]

    def step(states: dict, params: dict):
        vals: dict[tuple[str, str], Any] = {}
        new_states = dict(states)
        sink_out: dict[str, Any] = {}
        for b in order:
            ins = {e.dst_port: vals[(e.src.name, e.src_port)] for e in g.in_edges(b)}
            if n_shard > 1 and hasattr(b, "work_sharded"):
                st, outs = b.work_sharded(states[b.name], ins, params[b.name],
                                          n_out[b.name], mesh=mesh, axis=axis)
            else:
                st, outs = b.work(states[b.name], ins, params[b.name],
                                  n_out[b.name])
            new_states[b.name] = st
            if b.outputs:
                for p in b.outputs:
                    if p.name not in outs:
                        raise KeyError(f"{b.name}.work missing output {p.name!r}")
                    vals[(b.name, p.name)] = outs[p.name]
            elif outs is not None:
                sink_out[b.name] = outs
        return new_states, sink_out

    return step
