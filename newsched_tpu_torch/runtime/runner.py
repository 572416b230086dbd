"""Execution engine: runs a compiled flowgraph to completion, or until
stopped (reference: newsched_tpu/runtime/runner.py).

Two modes, as in the reference:

- Graph mode, the reference's scan mode (``Runner._run_scan``, a
  ``lax.scan`` of the step): on a CUDA device, whenever the run has at
  least two batches and none of the reference's ``_can_scan`` conditions
  stands against it (pacing, messages, checkpoints, stats; the port has no
  host I/O blocks yet). ``GRAPH_CHUNK`` steps are captured once as a
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
  i+1 while the device still computes batch i. Between batches it drains
  the message queue, rebinds changed parameters, paces throttled graphs,
  writes checkpoints and takes stats.

An unbounded graph runs only under ``start()`` (``start_async``), on a
thread of its own, until ``stop()``: as replays of the one captured chunk
(``_run_unbounded_chunked``; on the CPU the chunk's steps called), each
chunk's sink outputs copied to the host once, or, where graph mode is
ruled out, as the loop. Host memory stays bounded: each collecting sink
folds (``combine_collected``) or keeps a trailing window
(``collect_capacity``), or the run is refused before it starts.

Shutdown protocol: the reference's DONE -> FLUSH -> EXIT dance collapses to
arithmetic — the compiler knows each sink's exact total, the runner runs
exactly ``n_batches`` steps and trims each sink's final partial batch.

Checkpoints are ``torch.save`` files of the state tensors' CPU copies,
keyed by topological position (the reference writes Orbax trees).
"""

from __future__ import annotations

import collections
import gc
import os
import threading
import time
import traceback
from typing import Any

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


def _stack(trees: list):
    """Per-batch trees (tensors, dicts, TagBatches; None leaves) -> one tree
    with a leading batch axis on every tensor."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return torch.stack(trees)
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    return type(t0)(*(_stack([t[i] for t in trees]) for i in range(len(t0))))


def _cat(trees: list):
    """Trees with a leading batch axis (tensors or arrays) -> one tree,
    concatenated along it."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return torch.cat(trees)
    if isinstance(t0, np.ndarray):
        return np.concatenate(trees)
    if isinstance(t0, dict):
        return {k: _cat([t[k] for t in trees]) for k in t0}
    return type(t0)(*(_cat([t[i] for t in trees]) for i in range(len(t0))))


def _host(tree):
    """A tree of tensors -> the same tree of numpy arrays on the host."""
    if tree is None or isinstance(tree, np.ndarray):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return type(tree)(*(_host(v) for v in tree))


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
        # the blocks' attributes when it was built: a fence's hook replaces
        # a block's constants, and the captured graph still reads the old
        # tensors, which this keeps alive while the chunk lives
        self.keep: list = []

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
        return {name: _stack(v) for name, v in outs.items()}

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
        # thread_local: a run under start() captures on its own thread while
        # the caller's thread may use the card. The cyclic garbage collector
        # is held off meanwhile: a CUDA graph it frees in the middle of a
        # capture (one in cyclic garbage) ends the capture with an error.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = self.steps(self.C)
        finally:
            if gc_was_on:
                gc.enable()
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
        return _clone(self.out)


class Runner:
    """Compiles ``fg`` and runs it on ``device`` (the card unless the
    caller asks for the CPU): block states, parameters and every stream
    tensor are created there. With ``mesh`` (parallel.mesh.Mesh) the step
    shards over its time axis and everything lives on the mesh's device;
    a ``device`` that names another raises.

    resume_from / checkpoint_path, checkpoint_every: load the latest
    checkpoint under a directory before the first batch; write one every
    ``checkpoint_every`` batches and at the end. collect_stats: per-batch
    times in ``stats``. profile_dir: a torch.profiler trace of the run.
    tag_capacity_limit: the most tags an edge carries a batch
    (compile.build_step)."""

    def __init__(self, fg, device="cuda", batch_size: int | None = None,
                 total_items: int | None = None, mesh=None,
                 resume_from: str | None = None,
                 checkpoint_path: str | None = None, checkpoint_every: int = 0,
                 collect_stats: bool = False, profile_dir: str | None = None,
                 tag_capacity_limit: int | None = None):
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
        self.resume_from = resume_from
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.collect_stats = collect_stats
        self.profile_dir = profile_dir
        self.stats: dict = {"batches": 0, "items": 0, "batch_seconds": []}
        self.cfg = compile_flowgraph(fg, batch_size=batch_size,
                                     total_items=total_items, mesh=mesh,
                                     tag_capacity_limit=tag_capacity_limit)
        self._dirty_params: set[str] = set()
        # held while the runner steps, captures or refreshes parameters,
        # and by Block.set_param: a change lands between steps
        self.param_lock = threading.RLock()
        self._msg_queue: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._exc: str | None = None
        self._has_pacing = any(getattr(b, "pacing", None) for b in self.cfg.order)
        self._chunk: _Chunk | None = None
        self._collect_acc: dict[str, Any] = {}  # combine_collected folds
        self._dropped_items: dict[str, int] = {}  # ring-trimmed items a sink

    # -- control plane ---------------------------------------------------
    def invalidate_params(self, block) -> None:
        self._dirty_params.add(block.name)

    def enqueue_msg(self, block, port: str, msg: Any) -> None:
        self._msg_queue.append((block, port, msg))

    def _drain_msgs(self) -> None:
        while self._msg_queue:
            block, port, msg = self._msg_queue.popleft()
            block._msg_handlers[port](msg)

    def request_stop(self) -> None:
        self._stop.set()

    def init_states(self) -> dict:
        return self.cfg.init_states(self.device)

    def init_params(self) -> dict:
        return self.cfg.init_params(self.device)

    def _block(self, name: str):
        return next(b for b in self.cfg.order if b.name == name)

    # -- execution -------------------------------------------------------
    def run_to_completion(self) -> None:
        if not self.profile_dir:
            self._run_to_completion()
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self._run_to_completion()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))

    def _run_to_completion(self) -> None:
        for b in self.cfg.order:
            b._runtime = self
            b.start()
        try:
            if self.cfg.n_batches is None:
                raise ValueError(
                    "flowgraph is unbounded: add a head block, a finite source, "
                    "or pass total_items (or use start()/stop() for live runs)")
            if self.device.type == "cuda" and self._can_graph() \
                    and self.cfg.n_batches >= 2:
                self._run_graph(self.cfg.n_batches)
            else:
                self._run_loop(self.cfg.n_batches)
        finally:
            for b in self.cfg.order:
                b.stop()
                b._runtime = None

    def _can_graph(self) -> bool:
        """The reference's ``_can_scan``: no pacing, messages,
        checkpoints or stats, so every batch can stay on the device."""
        return not (self._has_pacing or self._msg_queue or self.resume_from
                    or self.checkpoint_path or self.collect_stats)

    def _run_loop(self, n_batches: int, unbounded: bool = False) -> None:
        with self.param_lock:
            params = self.init_params()
        start = 0
        if self.resume_from:
            states, start = self._load_checkpoint()
        else:
            states = self.init_states()
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        t0, done = time.monotonic(), start
        for i in range(start, n_batches):
            if self._stop.is_set():
                break
            bt0 = time.monotonic()
            self._drain_msgs()
            with self.param_lock:
                dirty, self._dirty_params = self._dirty_params, set()
                for name in dirty:
                    params[name] = self._block(name).param_leaves(self.device)
                states, sink_out = self.cfg.step(states, params)
            for name, v in sink_out.items():
                per_sink.setdefault(name, []).append(v)
            if unbounded:
                self._bound_collections(per_sink, per_batch=True)
            done = i + 1
            if self.checkpoint_path and self.checkpoint_every \
                    and done % self.checkpoint_every == 0:
                self._save_checkpoint(states, done)
            if self.collect_stats:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.stats["batch_seconds"].append(time.monotonic() - bt0)
            self.stats["batches"] += 1
            self.stats["items"] += self.cfg.batch_ref
            self._pace((done - start) * self.cfg.batch_ref, t0)
        if self.checkpoint_path:
            self._save_checkpoint(states, done)
        self._deliver({k: _stack(v) for k, v in per_sink.items() if v})

    def _pace(self, items_done: int, t0: float) -> None:
        """items_done is at the REFERENCE rate; each throttle paces by the
        item count in its own stream domain (rate-scaled), so a throttle
        after a decimator sees 1/decim of the reference items. The slowest
        throttle governs."""
        if not self._has_pacing:
            return
        target = 0.0
        for b in self.cfg.order:
            p = getattr(b, "pacing", None)
            if p:
                target = max(target, items_done * float(self.cfg.rates[b.name]) / p)
        dt = target - (time.monotonic() - t0)
        if dt > 0:
            time.sleep(dt)

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
        # the blocks' attributes, but not the runner: no cycle through it
        self._chunk.keep = [{k: v for k, v in vars(b).items() if k != "_runtime"}
                            for b in self.cfg.order]
        return self._chunk

    def _next_chunk(self, chunk: _Chunk) -> _Chunk:
        """At a chunk boundary, under the parameter lock: the parameters
        set since the last boundary copied into the chunk's tensors, and a
        new chunk (captured at its first run) where a fence moved."""
        dirty, self._dirty_params = self._dirty_params, set()
        self._refresh_params(chunk, dirty)
        if chunk.fences != self._fences():
            chunk = self._new_chunk(chunk.states, chunk.params, chunk.C)
        return chunk

    def _run_graph(self, n_batches: int, chunk_steps: int = GRAPH_CHUNK) -> None:
        """Graph mode: ``n_batches // chunk_steps`` runs of the chunk, then
        the remaining batches stepped directly, from the same stream state;
        every sink gets exactly what the loop delivers. The captured chunk
        is kept and replayed by the next run of this runner (its state and
        parameters reset in place) unless a fence parameter's value
        differs from the one it was captured with, whether it was set
        during a run or between runs."""
        with self.param_lock:
            chunk = self._chunk
            if chunk is None or chunk.C != chunk_steps \
                    or chunk.fences != self._fences():
                params = self.init_params() if chunk is None else chunk.params
                chunk = self._new_chunk(self.init_states(), params, chunk_steps)
            else:
                _copy_into(chunk.states, self.init_states())
            self._dirty_params = set()
            self._refresh_params(chunk, {b.name for b in self.cfg.order})
        per_sink: dict[str, list] = {}
        n_full, rem = divmod(n_batches, chunk_steps)
        for i in range(n_full + (rem > 0)):
            with self.param_lock:
                chunk = self._next_chunk(chunk)
                out = chunk.run() if i < n_full else chunk.steps(rem)
            for name, v in out.items():
                per_sink.setdefault(name, []).append(v)
        self.stats["batches"] += n_batches
        self.stats["items"] += n_batches * self.cfg.batch_ref
        self._deliver({k: _cat(v) for k, v in per_sink.items()})

    # -- checkpoint/resume: the state tensors between two batches --------
    def _save_checkpoint(self, states: dict, batch_idx: int) -> None:
        """CPU copies of every block's state tensors, keyed by topological
        position (block names differ between otherwise identical builds),
        in ``step_{batch_idx}/state.pt`` under checkpoint_path."""
        ordered = {f"b{i:04d}": [t.detach().cpu() for t in _tensors(states[b.name])]
                   for i, b in enumerate(self.cfg.order)}
        path = os.path.join(os.path.abspath(self.checkpoint_path),
                            f"step_{batch_idx}")
        os.makedirs(path, exist_ok=True)
        torch.save({"states": ordered, "batch_idx": batch_idx},
                   os.path.join(path, "state.pt"))

    def _load_checkpoint(self) -> tuple[dict, int]:
        """The latest checkpoint under resume_from, copied into a fresh
        state on the run's device; its batch index."""
        path = os.path.abspath(self.resume_from)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(path)
                       if d.startswith("step_"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        saved = torch.load(os.path.join(path, f"step_{steps[-1]}", "state.pt"),
                           weights_only=True)
        states = self.init_states()
        for i, b in enumerate(self.cfg.order):
            dst, src = _tensors(states[b.name]), saved["states"][f"b{i:04d}"]
            if [tuple(t.shape) for t in dst] != [tuple(t.shape) for t in src]:
                raise ValueError(f"checkpoint {path}: block {i} ({b.name}) "
                                 f"does not match this graph's state")
            for d, s in zip(dst, src):
                d.copy_(s)
        return states, int(saved["batch_idx"])

    # -- unbounded-run memory bounds -------------------------------------
    def _check_unbounded_sinks(self) -> None:
        for name in self.cfg.sink_totals:
            b = self._block(name)
            if hasattr(b, "combine_collected") \
                    or getattr(b, "collect_capacity", None) is not None:
                continue
            raise ValueError(
                f"sink {name!r} collects an UNBOUNDED stream into host "
                f"memory: give it a capacity (vector_sink(capacity=...)) or "
                f"bound the stream (head block / total_items)")

    def _bound_collections(self, per_sink: dict[str, list],
                           per_batch: bool) -> None:
        """Fold or trim live collections so host memory stays bounded.

        per_batch=True: entries are per-batch device values (loop mode):
        combiners fold every 256 batches; rings drop leading batches beyond
        the capacity window. per_batch=False: entries are host chunk trees
        with a leading batch axis (``_run_unbounded_chunked``)."""
        acc = self._collect_acc
        for name, lst in per_sink.items():
            if not lst:
                continue
            b = self._block(name)
            if hasattr(b, "combine_collected"):
                if not per_batch or len(lst) >= 256:
                    acc[name] = b.combine_collected(
                        acc.get(name), [_host(h) if per_batch else h
                                        for h in lst])
                    lst.clear()
                continue
            cap = getattr(b, "collect_capacity", None)
            if cap is None:
                continue

            def n_items(entry):
                if per_batch:
                    return self.cfg.n_in[name]
                data = entry["data"] if isinstance(entry, dict) else entry
                return int(data.shape[0]) * self.cfg.n_in[name]

            total = sum(n_items(e) for e in lst)
            while len(lst) > 1 and total - n_items(lst[0]) >= cap:
                total -= n_items(lst[0])
                self._dropped_items[name] = (self._dropped_items.get(name, 0)
                                             + n_items(lst.pop(0)))
            self.stats["retained_items"] = max(
                self.stats.get("retained_items", 0), total)

    # -- delivery --------------------------------------------------------
    def _trim(self, b, collected: np.ndarray) -> np.ndarray:
        """Drop leading garbage and the final partial batch's padding for
        stream-collecting sinks (the compiler's exact-totals arithmetic);
        ring-trimmed live collections already dropped their leading
        batches, and with them any leading garbage."""
        if not getattr(b, "collect_is_stream", True):
            return collected
        lead = max(0, self.cfg.sink_leads.get(b.name, 0)
                   - self._dropped_items.get(b.name, 0))
        total = self.cfg.sink_totals.get(b.name)
        end = None if total is None else lead + total
        return collected[lead:end]

    def _finalize_sink(self, b, stacked) -> None:
        """stacked: a host tree with a leading batch axis. Stream data has
        its batches flattened into the items; a TagBatch keeps its (batches,
        K) shape, from which the tags' absolute offsets are rebuilt and then
        moved back by the sink's lead."""
        from newsched_tpu_torch.runtime import tags as tags_mod

        total = self.cfg.sink_totals.get(b.name)

        def flat(a):
            return a.reshape((-1,) + a.shape[2:])

        if isinstance(stacked, dict) and getattr(b, "collects_tags", False):
            lead = max(0, self.cfg.sink_leads.get(b.name, 0)
                       - self._dropped_items.get(b.name, 0))
            raw = tags_mod.decode_batches(stacked["tags"], self.cfg.n_in[b.name])
            hi = np.inf if total is None else total
            tags = [t._replace(offset=t.offset - lead) for t in raw
                    if 0 <= t.offset - lead < hi]
            b.finalize({"data": self._trim(b, flat(stacked["data"])),
                        "tags": tags}, total)
        else:
            b.finalize(self._trim(b, flat(stacked)), total)

    def _deliver(self, stacked: dict[str, Any]) -> None:
        """Every sink's collection (device or host trees with a leading
        batch axis), moved to the host once, then finalized; the tag
        plane's drops counted into stats; the combiners' folds (unbounded
        runs) finalized from their accumulators."""
        host = {k: _host(v) for k, v in stacked.items()}
        drops = host.pop("__tag_drops__", None)
        if drops is not None:
            n = int(np.sum(drops))
            self.stats["tag_drops"] = self.stats.get("tag_drops", 0) + n
            if n:
                log.warning("tag_capacity_limit compaction dropped %d tags", n)
        for b in self.cfg.order:
            if b.name in self._collect_acc:
                if b.name in host:
                    self._collect_acc[b.name] = b.combine_collected(
                        self._collect_acc[b.name], list(host[b.name]))
                b.finalize(self._collect_acc[b.name], None)
            elif b.name in host:
                self._finalize_sink(b, host[b.name])

    # -- async (start/stop/wait) ------------------------------------------
    def start_async(self) -> None:
        # the run's card, for its thread: "cuda" is the caller's current one
        card = None
        if self.device.type == "cuda":
            card = self.device.index
            if card is None:
                card = torch.cuda.current_device()
        self._thread = threading.Thread(target=self._async_body, args=(card,),
                                        daemon=True)
        self._thread.start()

    def _async_body(self, card: int | None) -> None:
        try:
            if card is not None:
                torch.cuda.set_device(card)
            for b in self.cfg.order:
                b._runtime = self
                b.start()
            try:
                n = self.cfg.n_batches
                if n is None:
                    # until stop(), in bounded host memory: checked first
                    self._check_unbounded_sinks()
                    if self._can_graph():
                        self._run_unbounded_chunked()
                    else:
                        self._run_loop(1 << 62, unbounded=True)
                else:
                    self._run_loop(n)
            finally:
                for b in self.cfg.order:
                    b.stop()
                    b._runtime = None
        except Exception:  # raised again by wait()
            self._exc = traceback.format_exc()
            log.error("runner thread failed:\n%s", self._exc)

    def _run_unbounded_chunked(self, chunk_steps: int = GRAPH_CHUNK) -> None:
        """An unbounded stream as replays of the one captured chunk (on the
        CPU, the chunk's steps called) until stop(): parameters copied into
        the chunk's tensors in place between replays, a fence captured anew
        at the next boundary, each chunk's stacked sink outputs copied to
        the host once (which also waits for the replay), collections
        bounded as they arrive, and delivered on stop."""
        with self.param_lock:
            chunk = self._new_chunk(self.init_states(), self.init_params(),
                                    chunk_steps)
        per_sink: dict[str, list] = {name: [] for name in self.cfg.sink_totals}
        drops: list = []
        while not self._stop.is_set():
            self._drain_msgs()
            with self.param_lock:
                chunk = self._next_chunk(chunk)
                out = chunk.run()
            host = _host(out)
            if "__tag_drops__" in host:
                drops.append(host.pop("__tag_drops__"))
            for name, v in host.items():
                per_sink[name].append(v)
            self._bound_collections(per_sink, per_batch=False)
            self.stats["batches"] += chunk_steps
            self.stats["items"] += chunk_steps * self.cfg.batch_ref
        stacked = {k: _cat(v) for k, v in per_sink.items() if v}
        if drops:
            stacked["__tag_drops__"] = np.concatenate(drops)
        self._deliver(stacked)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._exc:
                raise RuntimeError(f"flowgraph execution failed:\n{self._exc}")
