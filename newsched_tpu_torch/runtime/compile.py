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
     (states, sink_outputs) that the runner calls once per batch, with the
     tag plane (runtime/tags.py) beside the stream edges.

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
                      time_axis: str | None = None,
                      tag_capacity_limit: int | None = None
                      ) -> CompiledFlowgraph:
    """batch_size: requested items/batch at the reference rate (rate-1 source).
    total_items: override stream length at the reference rate (else derived
    from head blocks / finite sources; None with no bound = unbounded).
    mesh: a parallel.mesh.Mesh; the step shards over ``time_axis`` (default
    the mesh's first axis). tag_capacity_limit: the most tags an edge
    carries a batch (``build_step``)."""
    order = g.topo_order()
    rates = _propagate_rates(g, order)
    shard_n = 1
    if mesh is not None:
        if mesh.world > 1:
            raise NotImplementedError(
                "a flowgraph on a process mesh is not ported, and the "
                "reference's fg.run cannot run on a multi-process mesh "
                "either (its runner fetches sink outputs with "
                "jax.device_get): step a block's work_sharded, or the "
                "sharded channelizer's step or step_planes, on each rank "
                "instead")
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

    step = build_step(g, order, n_out, n_in, mesh=mesh, time_axis=time_axis,
                      tag_capacity_limit=tag_capacity_limit)
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
               time_axis: str | None = None,
               tag_capacity_limit: int | None = None):
    """Emit the per-batch function ``step(states, params, host_ins=None)``.
    Sinks (no stream outputs) return a per-batch collected value under their
    name (None to collect nothing).

    ``host_ins`` maps the name of each host-ingest block (one defining
    ``host_pull``, e.g. file_source) to its batch, staged on the run's
    device; that block's ``work`` sees it as the pseudo input port
    "host_in".

    Under a mesh whose time axis is > 1, a block exposing ``work_sharded``
    runs its own per-shard formulation (the reference's explicit-collective
    lowering hook); every other block runs ``work`` on the whole batch.

    Tag plane (the reference's executor tag propagation per
    tag_propagation_policy_t): a shadow TagBatch per output port, of a
    static capacity propagated from each block's ``tag_capacity``
    (sources) through merges; a graph with no capacity carries none. A
    ``tag_aware`` block gets ``in_tags=`` and returns (state, outs,
    out_tags); any other follows its ``tag_policy``, its merged input tags
    remapped by n_out/n_in. A sink with ``collects_tags=True`` collects
    {"data", "tags"}. ``tag_capacity_limit`` caps every capacity: an edge
    over it is compacted each batch (valid tags first, in stream order)
    and the drops are summed into the pseudo sink "__tag_drops__". Under a
    mesh the tags ride with the whole batch, as the reference's step
    carries them."""
    from newsched_tpu_torch.runtime import tags as tags_mod

    n_in = n_in or {}
    n_shard, axis = 1, None
    if mesh is not None and mesh.size > 1:
        axis = time_axis or mesh.axis_names[0]
        n_shard = mesh.shape[axis]

    # Static tag capacity, per OUTPUT PORT (what one_to_one needs).
    caps: dict[tuple[str, str], int] = {}
    for b in order:
        in_caps = []
        for p in b.inputs:
            e = next((e for e in g.in_edges(b) if e.dst_port == p.name), None)
            in_caps.append(caps.get((e.src.name, e.src_port), 0) if e else 0)
        own = int(getattr(b, "tag_capacity", 0))
        policy = b.tag_policy
        if policy == "one_to_one" and b.inputs and b.outputs \
                and len(b.inputs) != len(b.outputs):
            raise ValueError(
                f"{b.name}: tag_policy 'one_to_one' requires equal input/"
                f"output port counts ({len(b.inputs)} vs {len(b.outputs)}), "
                "as in the reference's TPP_ONE_TO_ONE")
        for i, p in enumerate(b.outputs):
            if getattr(b, "tag_aware", False):
                c = sum(in_caps) + own
            elif policy == "one_to_one":
                c = (in_caps[i] if i < len(in_caps) else 0) + own
            elif policy == "dont":
                c = own
            else:  # all_to_all
                c = sum(in_caps) + own
            if tag_capacity_limit is not None:
                c = min(c, tag_capacity_limit)
            caps[(b.name, p.name)] = c
    any_tags = any(caps.values())

    def step(states: dict, params: dict, host_ins: dict | None = None):
        host_ins = host_ins or {}
        vals: dict[tuple[str, str], Any] = {}
        tag_vals: dict[tuple[str, str], Any] = {}  # (block, out port) -> TagBatch
        new_states = dict(states)
        sink_out: dict[str, Any] = {}
        tag_drops = None  # int32 0-dim tensor when compaction is active
        for b in order:
            ins = {e.dst_port: vals[(e.src.name, e.src_port)] for e in g.in_edges(b)}
            if b.name in host_ins:
                ins["host_in"] = host_ins[b.name]
            # tags on each input port, in declared port order (one_to_one
            # pairs input i with output i)
            in_tags: list[Any] = []
            if any_tags:
                for p in b.inputs:
                    e = next((e for e in g.in_edges(b) if e.dst_port == p.name),
                             None)
                    in_tags.append(tag_vals.get((e.src.name, e.src_port))
                                   if e else None)
            merged = None
            for t in in_tags:
                if t is not None:
                    merged = t if merged is None else tags_mod.merge(merged, t)
            ni, no = n_in.get(b.name, 0), n_out[b.name]

            def _remap(t):
                return (tags_mod.remap(t, no, ni)
                        if t is not None and ni and no and ni != no else t)

            if getattr(b, "tag_aware", False):
                st, outs, otags = b.work(states[b.name], ins, params[b.name],
                                         no, in_tags=merged)
                out_tags = {p.name: otags for p in b.outputs}
            else:
                if n_shard > 1 and hasattr(b, "work_sharded"):
                    st, outs = b.work_sharded(states[b.name], ins,
                                              params[b.name], no, mesh=mesh,
                                              axis=axis)
                else:
                    st, outs = b.work(states[b.name], ins, params[b.name], no)
                if b.tag_policy == "one_to_one":
                    out_tags = {p.name: _remap(in_tags[i] if i < len(in_tags)
                                               else None)
                                for i, p in enumerate(b.outputs)}
                elif b.tag_policy == "dont":
                    out_tags = {p.name: None for p in b.outputs}
                else:  # all_to_all
                    out_tags = {p.name: _remap(merged) for p in b.outputs}
            new_states[b.name] = st
            if b.outputs:
                for p in b.outputs:
                    if p.name not in outs:
                        raise KeyError(f"{b.name}.work missing output {p.name!r}")
                    vals[(b.name, p.name)] = outs[p.name]
                    t = out_tags[p.name]
                    if (tag_capacity_limit is not None and t is not None
                            and t.capacity > tag_capacity_limit):
                        t, dropped = tags_mod.compact(t, tag_capacity_limit)
                        tag_drops = (dropped if tag_drops is None
                                     else tag_drops + dropped)
                    tag_vals[(b.name, p.name)] = t
            elif getattr(b, "collects_tags", False) and merged is not None:
                sink_out[b.name] = {"data": outs, "tags": merged}
            elif outs is not None:
                sink_out[b.name] = outs
        if tag_drops is not None:
            sink_out["__tag_drops__"] = tag_drops
        return new_states, sink_out

    return step
