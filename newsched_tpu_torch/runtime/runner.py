"""Execution engine: runs a compiled flowgraph to completion (reference:
newsched_tpu/runtime/runner.py).

Loop mode: a Python loop calls the compiled step once per batch on the
run's device. Kernel launches are asynchronous, so the host enqueues batch
i+1 while the device still computes batch i; the only synchronisation is
the sink delivery after the last batch.

Shutdown protocol: the reference's DONE -> FLUSH -> EXIT dance collapses to
arithmetic — the compiler knows each sink's exact total, the runner runs
exactly ``n_batches`` steps and trims each sink's final partial batch.

Later slices bring the reference's other modes: a captured CUDA graph of K
steps in place of its ``lax.scan`` mode, checkpoints, stats and the async
start()/stop() control plane.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.runtime.compile import compile_flowgraph
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("runner")


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
