"""Graph model: edges, hierarchical blocks, flowgraph (reference:
newsched_tpu/runtime/graph.py).

Construction mirrors the reference API:

    fg = Flowgraph()
    fg.connect(src, 0, fir, 0)          # GR-style positional
    fg.connect(src.o(), fir.i())        # endpoint sugar
    fg.run(device="cuda")               # validate + compile + execute

Every edge is a tensor handed from one block's ``work`` to the next inside
one step; the graph boundary (sources and sinks) is where data enters and
leaves the device.
"""

from __future__ import annotations

import dataclasses

from newsched_tpu_torch.runtime.block import Block, Port, _PortRef
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("graph")


@dataclasses.dataclass(frozen=True)
class Edge:
    src: Block
    src_port: str
    dst: Block
    dst_port: str

    def __repr__(self):
        return f"{self.src.name}.{self.src_port}->{self.dst.name}.{self.dst_port}"


class Graph:
    """Construction-time topology (reference: graph.h)."""

    def __init__(self):
        self.blocks: list[Block] = []
        self.edges: list[Edge] = []

    def _add_block(self, b: Block) -> None:
        if b not in self.blocks:
            if any(x.name == b.name for x in self.blocks):
                raise ValueError(f"duplicate block name {b.name}")
            self.blocks.append(b)

    def connect(self, *args) -> Edge:
        """connect(src, sport, dst, dport) | connect(src.o(), dst.i()) |
        connect(src, dst) (port 0 -> port 0)."""
        if len(args) == 4:
            src, sport, dst, dport = args
        elif len(args) == 2:
            a, b = args
            src, sport = (a.block, a.port) if isinstance(a, _PortRef) else (a, 0)
            dst, dport = (b.block, b.port) if isinstance(b, _PortRef) else (b, 0)
        else:
            raise TypeError("connect takes (src, sport, dst, dport) or two endpoints")
        # Hier blocks flatten on the spot: absorb the inner graph and
        # resolve the exported endpoint (reference: flat_graph::make).
        if isinstance(src, HierBlock):
            self._absorb(src.graph)
            ref = src.resolve_output(sport)
            src, sport = ref.block, ref.port
        if isinstance(dst, HierBlock):
            self._absorb(dst.graph)
            ref = dst.resolve_input(dport)
            dst, dport = ref.block, ref.port
        sp = src.output_port(sport)
        dp = dst.input_port(dport)
        if not sp.compatible_with(dp):
            raise TypeError(
                f"port type mismatch: {src.name}.{sp.name} "
                f"({sp.dtype.name}{sp.item_shape}) -> {dst.name}.{dp.name} "
                f"({dp.dtype.name}{dp.item_shape})"
            )
        for e in self.edges:
            if e.dst is dst and e.dst_port == dp.name:
                raise ValueError(f"input {dst.name}.{dp.name} already connected")
        self._add_block(src)
        self._add_block(dst)
        edge = Edge(src, sp.name, dst, dp.name)
        self.edges.append(edge)
        return edge

    def msg_connect(self, src: Block, out_port: str, dst: Block, in_port: str) -> None:
        """Wire an async message path (reference: graph msg edges)."""
        if in_port not in dst._msg_handlers:
            raise KeyError(f"{dst.name} has no message input {in_port!r}")
        src._msg_subscribers.setdefault(out_port, []).append((dst, in_port))
        self._add_block(src)
        self._add_block(dst)

    def _absorb(self, other: "Graph | None") -> None:
        if other is None:
            return
        for b in other.blocks:
            self._add_block(b)
        for e in other.edges:
            if e not in self.edges:
                self.edges.append(e)

    # -- introspection --------------------------------------------------
    def in_edges(self, b: Block) -> list[Edge]:
        return [e for e in self.edges if e.dst is b]

    def out_edges(self, b: Block) -> list[Edge]:
        return [e for e in self.edges if e.src is b]

    def validate(self) -> None:
        """Every input port connected; graph acyclic (reference:
        flowgraph::validate)."""
        for b in self.blocks:
            connected = {e.dst_port for e in self.in_edges(b)}
            for p in b.inputs:
                if p.name not in connected:
                    raise ValueError(f"unconnected input {b.name}.{p.name}")
        self.topo_order()

    def topo_order(self) -> list[Block]:
        indeg = {b.name: 0 for b in self.blocks}
        for e in self.edges:
            indeg[e.dst.name] += 1
        ready = [b for b in self.blocks if indeg[b.name] == 0]
        order: list[Block] = []
        while ready:
            b = ready.pop()
            order.append(b)
            for e in self.out_edges(b):
                indeg[e.dst.name] -= 1
                if indeg[e.dst.name] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.blocks):
            raise ValueError("flowgraph contains a cycle")
        return order


class HierBlock(Block):
    """Nested subgraph with forwarded ports (reference: hier_block.h).

    Subclasses build an internal Graph and map exported port names to
    internal endpoints:

        class FmDemod(HierBlock):
            def __init__(self):
                super().__init__()
                ... build self.graph ...
                self.map_input("in", inner_first.i())
                self.map_output("out", inner_last.o())

    Flattening is implicit: connect() resolves hier endpoints to the inner
    blocks and absorbs the inner graph (reference: flat_graph).
    """

    def __init__(self, name: str | None = None):
        super().__init__(name)
        self.graph = Graph()
        self._in_map: dict[str, _PortRef] = {}
        self._out_map: dict[str, _PortRef] = {}

    def map_input(self, name: str, inner: _PortRef) -> None:
        self._in_map[name] = inner
        p = inner.block.input_port(inner.port)
        self.inputs.append(Port(name, p.dtype, "input", p.item_shape))

    def map_output(self, name: str, inner: _PortRef) -> None:
        self._out_map[name] = inner
        p = inner.block.output_port(inner.port)
        self.outputs.append(Port(name, p.dtype, "output", p.item_shape))

    def resolve_input(self, key: str | int) -> _PortRef:
        name = self.input_port(key).name
        return self._in_map[name]

    def resolve_output(self, key: str | int) -> _PortRef:
        name = self.output_port(key).name
        return self._out_map[name]

    def work(self, *a, **k):  # hier blocks never execute directly
        raise RuntimeError("hier block was not flattened")


class Flowgraph(Graph):
    """Top-level runnable graph (reference: flowgraph.h + runtime
    start/wait). run() is synchronous: validate -> compile -> execute ->
    deliver sink data. start()/wait()/stop() are the reference's async API:
    the run goes on on a thread of its own, an unbounded one until stop()."""

    def __init__(self, name: str = "flowgraph", batch_size: int | None = None):
        Graph.__init__(self)
        self.name = name
        self.batch_size = batch_size
        self._runner = None

    def run(self, device="cuda", batch_size: int | None = None,
            total_items: int | None = None, mesh=None, **runner_kwargs):
        """Synchronous run on ``device`` (a torch device or its name): the
        card unless the caller asks for the CPU (``device="cpu"``). Every
        block's state, parameters and stream tensors live there; the run
        does not move to another device. ``mesh`` (parallel.make_mesh)
        shards the step over its time axis; ``device`` must agree with the
        mesh's device (``fg.run(device="cpu", mesh=make_mesh(4,
        device="cpu"))`` in the tests). Other keyword arguments reach the
        Runner: resume_from, checkpoint_path, checkpoint_every,
        collect_stats, profile_dir, tag_capacity_limit."""
        from newsched_tpu_torch.runtime.runner import Runner

        self.validate()
        runner = Runner(self, batch_size=batch_size or self.batch_size,
                        total_items=total_items, device=device, mesh=mesh,
                        **runner_kwargs)
        runner.run_to_completion()
        return runner

    def start(self, device="cuda", batch_size: int | None = None, mesh=None,
              **runner_kwargs):
        """Start the run on a thread of its own and return its Runner; an
        unbounded graph runs until stop(). Arguments as run()."""
        from newsched_tpu_torch.runtime.runner import Runner

        self.validate()
        self._runner = Runner(self, batch_size=batch_size or self.batch_size,
                              device=device, mesh=mesh, **runner_kwargs)
        self._runner.start_async()
        return self._runner

    def wait(self):
        """Wait for the run started by start() to end; raises what failed
        on its thread."""
        if self._runner is None:
            raise RuntimeError("flowgraph not started")
        try:
            self._runner.wait()
        finally:
            self._runner = None

    def stop(self):
        """Ask the run started by start() to stop at its next batch (graph
        mode: chunk) boundary; wait() then delivers what streamed."""
        if self._runner is not None:
            self._runner.request_stop()
