"""Distributed flowgraph runtime (reference: newsched_tpu/runtime/
distributed.py; GNU Radio 4.0's runtime, runtime_monitor, runtime_proxy
and graph_utils::partition).

One logical flowgraph is split into subgraphs, one a group; every edge
that crosses groups becomes a push_sink in the source's group and a
pull_source in the destination's, joined over the port's own ZMTP
(``io/zmtp.py``; the reference's buffer_net_zmq). Each partition then runs
as an ordinary flowgraph:

- ``Runtime.run()`` runs every partition of this process on a thread of
  its own, all on one device (one card: the partitions share it, and the
  runner's host-I/O rule keeps each in its loop, never in a captured
  graph, since its edges are host I/O);
- across processes or hosts, each process builds its own partition (the
  same code, the same addresses) and runs it; EOF and abort frames on the
  edges and the control plane (``runtime/control.py``) stand in for the
  reference's runtime_proxy messages.
"""

from __future__ import annotations

import os
import secrets
import tempfile
import threading
import traceback

from newsched_tpu_torch.runtime.graph import Flowgraph
from newsched_tpu_torch.utils.logger import get_logger

log = get_logger("distributed")


def edge_address() -> str:
    """A fresh ``ipc://`` address no other process can hold: a path under
    the temporary directory named by this process's id and 48 random
    bits. (The reference counts TCP ports up from 52000 in each process,
    so two processes pick the same ones.)"""
    name = f"nst-{os.getpid()}-{secrets.token_hex(6)}.ipc"
    return f"ipc://{os.path.join(tempfile.gettempdir(), name)}"


def partition_flowgraph(fg: Flowgraph, groups: dict[str, list],
                        addresses: dict | None = None,
                        hwm: int | None = None) -> dict[str, Flowgraph]:
    """Split ``fg`` into one Flowgraph a group (reference:
    graph_utils::partition + buffer_net_zmq insertion).

    groups: group name -> its blocks; every block in exactly one group.
    Each crossing edge gets a push_sink (bound) in the source's group and
    a pull_source (connecting) in the destination's, at
    ``addresses[(src_name, src_port)]`` when given (a tcp:// one to cross
    hosts), else at a fresh ``edge_address()``. Tags ride the edge: each
    receiver re-emits up to the whole graph's ``tag_capacity`` a batch.
    ``hwm`` (default: the transport's 1000 messages at each end) bounds
    how far a partition can run ahead of the one it feeds: its push_sink
    queues at most ``hwm`` batches and the pull_source holds at most
    ``hwm``, past which the sender blocks (the sockets' kernel buffers
    hold a few more).
    """
    from newsched_tpu_torch.blocks import zmq as zmq_blocks

    owner: dict[str, str] = {}
    for gname, blocks in groups.items():
        for b in blocks:
            if b.name in owner:
                raise ValueError(f"block {b.name} assigned to two groups")
            owner[b.name] = gname
    for b in fg.blocks:
        if b.name not in owner:
            raise ValueError(f"block {b.name} not assigned to any group")

    out = {g: Flowgraph(f"{fg.name}:{g}", fg.batch_size) for g in groups}
    addresses = dict(addresses or {})
    tag_cap = sum(int(getattr(b, "tag_capacity", 0)) for b in fg.blocks)
    for e in fg.edges:
        sg, dg = owner[e.src.name], owner[e.dst.name]
        if sg == dg:
            out[sg].connect(e.src, e.src_port, e.dst, e.dst_port)
            continue
        key = (e.src.name, e.src_port)
        addr = addresses.setdefault(key, edge_address())
        sp = e.src.output_port(e.src_port)
        snk = zmq_blocks.push_sink(addr, bind=True, dtype=sp.dtype,
                                   vlen=sp.item_shape, sndhwm=hwm,
                                   name=f"xfer_out_{e.src.name}_{e.src_port}")
        srcb = zmq_blocks.pull_source(addr, bind=False, dtype=sp.dtype,
                                      vlen=sp.item_shape, tag_capacity=tag_cap,
                                      rcvhwm=hwm,
                                      name=f"xfer_in_{e.dst.name}_{e.dst_port}")
        out[sg].connect(e.src, e.src_port, snk, 0)
        out[dg].connect(srcb, 0, e.dst, e.dst_port)
    return out


class Runtime:
    """Run several partitions at once in this process, each on a thread of
    its own, on ``device`` (reference: runtime::initialize + start/wait,
    a scheduler a partition).

    Fail fast (reference: runtime_monitor/proxy mirroring DONE/FLUSH/EXIT):
    a partition that fails ships abort frames on its outgoing edges (the
    partitions downstream fail within one batch) and stops its siblings
    here at once; ``wait()`` then raises the first error. ``stop()`` ends
    a running distributed graph cleanly. ``control_addresses`` (partition
    name -> address) serve each named partition's blocks to remote
    ``RuntimeClient``\\ s (runtime/control.py), keyed by
    ``control_auth_key`` when given."""

    def __init__(self, partitions: dict[str, Flowgraph],
                 total_items: dict[str, int] | None = None,
                 control_addresses: dict[str, str] | None = None,
                 control_auth_key: bytes | None = None, device="cuda"):
        self.partitions = partitions
        self.total_items = total_items or {}
        self.device = device
        self._threads: list[threading.Thread] = []
        self._errors: dict[str, str] = {}
        self._error_order: list[str] = []
        self._lock = threading.Lock()
        self._runners: dict[str, object] = {}
        self._control_servers: list = []
        for name, addr in (control_addresses or {}).items():
            if name not in partitions:
                raise ValueError(f"control address for unknown partition "
                                 f"{name!r}")
            from newsched_tpu_torch.runtime.control import ControlServer

            def _blk(bname, _fg=partitions[name]):
                return next((b for b in _fg.blocks if b.name == bname), None)

            self._control_servers.append(ControlServer(
                addr, lambda _n=name: self._runners.get(_n), _blk,
                auth_key=control_auth_key))

    def start(self) -> None:
        from newsched_tpu_torch.runtime.block import StreamAborted
        from newsched_tpu_torch.runtime.runner import Runner

        def run_one(name: str, fg: Flowgraph):
            runner = None
            try:
                fg.validate()
                runner = Runner(fg, device=self.device,
                                batch_size=fg.batch_size,
                                total_items=self.total_items.get(name))
                with self._lock:
                    self._runners[name] = runner
                runner.run_to_completion()
            except StreamAborted:
                log.info("partition %s aborted cleanly", name)
            except Exception:  # the partition's boundary: recorded, raised by wait()
                with self._lock:
                    self._errors[name] = traceback.format_exc()
                    self._error_order.append(name)
                log.error("partition %s failed:\n%s", name, self._errors[name])
                if runner is not None:
                    runner.abort_peers()
                self._stop_siblings(name)

        for name, fg in self.partitions.items():
            t = threading.Thread(target=run_one, args=(name, fg), daemon=True,
                                 name=f"partition-{name}")
            self._threads.append(t)
            t.start()

    def _stop_siblings(self, failed: str) -> None:
        with self._lock:
            runners = [r for n, r in self._runners.items() if n != failed]
        for runner in runners:
            runner.request_stop()

    def stop(self) -> None:
        """Abort every partition cleanly (reference: runtime stop broadcast)."""
        with self._lock:
            runners = list(self._runners.values())
        for runner in runners:
            runner.request_stop()

    def wait(self) -> None:
        for t in self._threads:
            t.join()
        for s in self._control_servers:
            s.close()
        self._control_servers.clear()
        if self._errors:
            first = self._error_order[0]
            raise RuntimeError(
                f"partition {first!r} failed (all failed: {list(self._errors)})\n"
                + self._errors[first])

    def run(self) -> None:
        self.start()
        self.wait()
