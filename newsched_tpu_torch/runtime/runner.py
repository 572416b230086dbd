"""Execution engine: runs a compiled flowgraph to completion (reference:
newsched_tpu/runtime/runner.py).

Two modes, as in the reference:

- Graph mode, the reference's scan mode (``Runner._run_scan``, a
  ``lax.scan`` of the step): on a CUDA device, whenever the run has at
  least two batches (the reference's ``_can_scan`` conditions, host I/O,
  pacing, messages, checkpoints and stats, have no port yet, so nothing
  else stands against it). ``GRAPH_CHUNK`` steps are captured once as a
  CUDA graph and the graph is replayed batch chunk after batch chunk; the
  remaining batches run through the step directly. It works because every
  piece of stream state (NCO phases, noise counters, first-batch flags,
  read positions) and every parameter is a tensor on the card that the
  step reads and advances: a replay continues the stream where the one
  before left it. A parameter set between chunks is copied into its
  tensor in place; a fence parameter (``center_freq``) captures anew, as
  the reference retraces. On the CPU the same chunk bookkeeping runs with
  the step called directly (``_run_graph``), which is what the CPU tests
  hold against the loop.
- Loop mode (``_run_loop``): a Python loop calls the compiled step once
  per batch. Kernel launches are asynchronous, so the host enqueues batch
  i+1 while the device still computes batch i; the only synchronisation
  is the sink delivery after the last batch.

Shutdown protocol: the reference's DONE -> FLUSH -> EXIT dance collapses to
arithmetic — the compiler knows each sink's exact total, the runner runs
exactly ``n_batches`` steps and trims each sink's final partial batch.

Later slices bring checkpoints, stats and the async start()/stop() control
plane (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.runtime.block import param_tensor
from newsched_tpu_torch.runtime.compile import compile_flowgraph
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("runner")

# Steps in one captured graph: the runner replays it n_batches // GRAPH_CHUNK
# times. Measured on the H100 at 2, 4, 8 and 16 steps (chip_smoke.py phase
# 34, PERF.md §6): within 2% of each other on a host-bound and a
# device-bound cell, since one replay's launch is small beside a step; the
# chunk's stacked outputs grow with it.
GRAPH_CHUNK = 8


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a state or parameter tree (dicts, tuples, NamedTuples),
    in order; anything else raises: the stream state a captured graph
    replays must live on the device."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    raise TypeError(f"stream state {type(tree).__name__} {tree!r} is not a "
                    f"tensor: a captured step could not advance it")


def _copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (the same structure), in place; a tensor handed back unchanged
    is skipped."""
    for d, s in zip(_tensors(dst), _tensors(src), strict=True):
        if d is not s:
            d.copy_(s)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _launch_counts() -> list[int]:
    from newsched_tpu_torch.ops.cuda import launch_counters

    return [getattr(f, a) for f, a in launch_counters()]


def _set_launch_counts(counts: list[int]) -> None:
    from newsched_tpu_torch.ops.cuda import launch_counters

    for (f, a), n in zip(launch_counters(), counts, strict=True):
        setattr(f, a, n)


class _Chunk:
    """C steps of the compiled step from the run's stream state ``states``
    (tensors the chunk owns and advances in place): on a CUDA device one
    captured graph, replayed; on the CPU the same steps called directly.
    Each run of the chunk hands back every sink's C outputs stacked."""

    def __init__(self, step, states: dict, params: dict, C: int, device):
        self.step, self.states, self.params, self.C = step, states, params, C
        self.cuda = torch.device(device).type == "cuda"
        self.graph = None
        self.out: dict = {}
        self.launches: list[int] = []
        self.fences: dict = {}  # the fence parameters it was built with

    def steps(self, n: int) -> dict:
        """n steps, directly: the new state is copied into ``states``, so
        the next call continues the stream; per sink the n outputs stacked
        (the static per-chunk buffers, inside a captured graph)."""
        st, outs = self.states, {}
        for _ in range(n):
            st, sink_out = self.step(st, self.params)
            for name, v in sink_out.items():
                outs.setdefault(name, []).append(v)
        _copy_into(self.states, st)
        return {name: torch.stack(v) for name, v in outs.items()}

    def capture(self) -> None:
        """Capture the chunk. One warm-up step first, on a side stream,
        builds the kernels and fills each block's per-device caches (no
        upload may happen inside the capture); it advances the stream
        state, so the state is snapshotted before and restored after it,
        and neither the warm-up's nor the capture's launches are counted:
        the replays count theirs."""
        snap = _clone(self.states)
        counts = _launch_counts()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.steps(1)
        torch.cuda.current_stream().wait_stream(side)
        _copy_into(self.states, snap)
        _set_launch_counts(counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self.steps(self.C)
        self.launches = [a - b for a, b in zip(_launch_counts(), counts)]
        _set_launch_counts(counts)

    def run(self) -> dict:
        """The chunk's C steps: the graph replayed (captured at the first
        run; no synchronisation) and its outputs cloned, or on the CPU the
        steps called."""
        if not self.cuda:
            return self.steps(self.C)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        _set_launch_counts([a + b for a, b in zip(_launch_counts(),
                                                  self.launches)])
        return {name: v.clone() for name, v in self.out.items()}


class Runner:
    """Compiles ``fg`` and runs it on ``device`` (the card unless the
    caller asks for the CPU): block states, parameters and every stream
    tensor are created there. With ``mesh`` (parallel.mesh.Mesh) the step
    shards over its time axis and everything lives on the mesh's device;
    a ``device`` that names another raises."""

    def __init__(self, fg, device="cuda", batch_size: int | None = None,
                 total_items: int | None = None, mesh=None):
        self.fg = fg
        self.device = torch.device(device)
        if mesh is not None:
            on = mesh.device
            if self.device.type != on.type or self.device.index not in (
                    None, on.index):
                raise ValueError(
                    f"device={str(device)!r} contradicts the mesh, whose "
                    f"shards are on {on}: pass device={str(on)!r}")
            self.device = on
        self.cfg = compile_flowgraph(fg, batch_size=batch_size,
                                     total_items=total_items, mesh=mesh)
        self._dirty_params: set[str] = set()
        self._chunk: _Chunk | None = None

    def invalidate_params(self, block) -> None:
        self._dirty_params.add(block.name)

    def init_states(self) -> dict:
        return self.cfg.init_states(self.device)

    def init_params(self) -> dict:
        return self.cfg.init_params(self.device)

    # -- execution -------------------------------------------------------
    def run_to_completion(self) -> None:
        for b in self.cfg.order:
            b._runtime = self
            b.start()
        try:
            if self.cfg.n_batches is None:
                raise ValueError(
                    "flowgraph is unbounded: add a head block, a finite source, "
                    "or pass total_items"
                )
            if self.device.type == "cuda" and self.cfg.n_batches >= 2:
                self._run_graph(self.cfg.n_batches)
            else:
                self._run_loop(self.cfg.n_batches)
        finally:
            for b in self.cfg.order:
                b.stop()
                b._runtime = None

    def _run_loop(self, n_batches: int) -> None:
        params = self.init_params()
        states = self.init_states()
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        for _ in range(n_batches):
            dirty, self._dirty_params = self._dirty_params, set()
            for name in dirty:
                blk = next(b for b in self.cfg.order if b.name == name)
                params[name] = blk.param_leaves(self.device)
            states, sink_out = self.cfg.step(states, params)
            for name, v in sink_out.items():
                per_sink.setdefault(name, []).append(v)
        self._deliver_batches({k: v for k, v in per_sink.items() if v})

    def _refresh_params(self, chunk: _Chunk, names) -> None:
        """Copy the blocks' current parameter values into the tensors the
        chunk reads, in place."""
        for b in self.cfg.order:
            if b.name in names:
                for k, spec in b._param_specs.items():
                    chunk.params[b.name][k].copy_(param_tensor(
                        b.get_param(k), spec.dtype, "cpu"))

    def _fences(self) -> dict:
        """The fence parameters' values, which a captured chunk bakes in."""
        return {(b.name, k): b.get_param(k) for b in self.cfg.order
                for k, spec in b._param_specs.items() if spec.fence}

    def _new_chunk(self, states: dict, params: dict, chunk_steps: int):
        self._chunk = _Chunk(self.cfg.step, states, params, chunk_steps,
                             self.device)
        self._chunk.fences = self._fences()
        return self._chunk

    def _run_graph(self, n_batches: int, chunk_steps: int = GRAPH_CHUNK) -> None:
        """Graph mode: ``n_batches // chunk_steps`` runs of the chunk, then
        the remaining batches stepped directly, from the same stream state;
        every sink gets exactly what the loop delivers. The captured chunk
        is kept and replayed by the next run of this runner (its state and
        parameters reset in place) unless a fence parameter's value
        differs from the one it was captured with, whether it was set
        during a run or between runs."""
        chunk = self._chunk
        if chunk is None or chunk.C != chunk_steps \
                or chunk.fences != self._fences():
            params = self.init_params() if chunk is None else chunk.params
            chunk = self._new_chunk(self.init_states(), params, chunk_steps)
        else:
            _copy_into(chunk.states, self.init_states())
        self._dirty_params = set()
        self._refresh_params(chunk, {b.name for b in self.cfg.order})
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        n_full, rem = divmod(n_batches, chunk_steps)
        for i in range(n_full + (rem > 0)):
            dirty, self._dirty_params = self._dirty_params, set()
            self._refresh_params(chunk, dirty)
            if chunk.fences != self._fences():
                chunk = self._new_chunk(chunk.states, chunk.params,
                                        chunk_steps)
            out = chunk.run() if i < n_full else chunk.steps(rem)
            for name, v in out.items():
                per_sink.setdefault(name, []).append(
                    v.flatten(0, 1) if v.dim() > 1 else v)
        self._deliver_batches({k: v for k, v in per_sink.items() if v})

    # -- delivery --------------------------------------------------------
    def _trim(self, b, collected: np.ndarray) -> np.ndarray:
        """Drop leading garbage and the final partial batch's padding for
        stream-collecting sinks (the compiler's exact-totals arithmetic)."""
        if not getattr(b, "collect_is_stream", True):
            return collected
        lead = self.cfg.sink_leads.get(b.name, 0)
        total = self.cfg.sink_totals.get(b.name)
        end = None if total is None else lead + total
        return collected[lead:end]

    def _deliver_batches(self, per_sink: dict[str, list]) -> None:
        for b in self.cfg.order:
            batches = per_sink.get(b.name)
            if not batches:
                continue
            host = np.concatenate([np.atleast_1d(t.cpu().numpy())
                                   for t in batches])
            b.finalize(self._trim(b, host), self.cfg.sink_totals.get(b.name))
