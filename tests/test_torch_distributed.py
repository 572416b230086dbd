"""The port's distributed runtime and control plane
(newsched_tpu_torch/runtime/distributed.py, control.py) held against the
JAX package: the twins of tests/test_distributed.py's ten tests at small
sizes, each running its graph through both packages, then a JAX partition
feeding a port partition, a JAX client driving a port server, the
loopback check by exact host parsing and the replay guard on keyed
frames. Every address is a fresh ipc:// path or an OS-chosen port, never
the reference's fixed ones; every thread and child is joined with a
timeout; nothing is decided by a sleep."""

import logging
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from newsched_tpu import Flowgraph as JFlowgraph
from newsched_tpu.blocks import general as jgen, math as jmath, zmq as jzmq
from newsched_tpu.runtime.block import Block as JBlock
from newsched_tpu.runtime.control import RuntimeClient as JClient
from newsched_tpu.runtime.distributed import (Runtime as JRuntime,
                                              partition_flowgraph as jpartition)
from newsched_tpu.runtime.runner import Runner as JRunner

from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general, math as gmath, zmq as tzmq
from newsched_tpu_torch.io import zmtp
from newsched_tpu_torch.runtime import control
from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.runtime.control import ControlServer, RuntimeClient
from newsched_tpu_torch.runtime.distributed import (Runtime, edge_address,
                                                    partition_flowgraph)
from newsched_tpu_torch.runtime.runner import Runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120  # the longest a partition, a thread or a child may take
RTOL = 1e-6   # the port's complex64 products against XLA's


def _cf32(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _jax_addresses(fg, groups) -> dict:
    """A fresh ipc address for each crossing edge of a JAX graph (its
    partition_flowgraph would count TCP ports from 52000)."""
    owner = {b.name: g for g, bs in groups.items() for b in bs}
    return {(e.src.name, e.src_port): edge_address() for e in fg.edges
            if owner[e.src.name] != owner[e.dst.name]}


def _wait(rt) -> None:
    """Runtime.wait(), its partitions joined with a timeout first."""
    for t in rt._threads:
        t.join(JOIN_S)
        assert not t.is_alive(), f"{t.name} did not finish"
    rt.wait()


def _await(cond, what: str, limit_s: float = JOIN_S) -> None:
    deadline = time.monotonic() + limit_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _chain(pkg, data, k, tags=None, repeat=False, throttle=None, name=None):
    """vector_source -> copy [-> throttle] -> multiply_const(k) ->
    vector_sink of either package; returns (graph, src, cp, mc, snk, thr)."""
    FG, gen, gm = ((Flowgraph, general, gmath) if pkg == "torch"
                   else (JFlowgraph, jgen, jmath))
    fg = FG(batch_size=512)
    src = gen.vector_source(data, tags=tags, repeat=repeat)
    cp = gen.copy()
    thr = gen.throttle(throttle) if throttle else None
    mc = gm.multiply_const(k, dtype="cf32", name=name)
    snk = gen.vector_sink()
    fg.connect(src, 0, cp, 0)
    if thr is not None:
        fg.connect(cp, 0, thr, 0)
        fg.connect(thr, 0, mc, 0)
    else:
        fg.connect(cp, 0, mc, 0)
    fg.connect(mc, 0, snk, 0)
    return fg, src, cp, mc, snk, thr


def _partitioned(pkg, fg, groups, total_items, **kw):
    if pkg == "torch":
        return Runtime(partition_flowgraph(fg, groups), total_items=total_items,
                       device="cpu", **kw)
    return JRuntime(jpartition(fg, groups, _jax_addresses(fg, groups)),
                    total_items=total_items, **kw)


def test_partition_two_groups_threads():
    """One graph split over two partitions on threads, joined by a ZMQ
    edge: each package's sink is the unsplit product, and the two agree
    within RTOL."""
    data = _cf32(4096, seed=50)
    out = {}
    for pkg in ("torch", "jax"):
        fg, src, cp, mc, snk, _ = _chain(pkg, data, 2.0 + 1.0j)
        groups = {"head": [src, cp], "tail": [mc, snk]}
        if pkg == "torch":
            parts = partition_flowgraph(fg, groups)
            assert [b.name for b in parts["head"].blocks][-1].startswith("xfer_out")
            assert len(parts["head"].blocks) == 3
            assert len(parts["tail"].blocks) == 3
        rt = _partitioned(pkg, fg, groups, {"tail": len(data)})
        rt.start()
        _wait(rt)
        out[pkg] = snk.data()
    np.testing.assert_allclose(out["torch"], data * (2.0 + 1.0j), rtol=RTOL)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=RTOL)


def test_partition_rejects_unassigned():
    for FG, gen, part in ((Flowgraph, general, partition_flowgraph),
                          (JFlowgraph, jgen, jpartition)):
        fg = FG(batch_size=64)
        src = gen.null_source()
        snk = gen.null_sink()
        fg.connect(src, 0, snk, 0)
        with pytest.raises(ValueError, match="not assigned"):
            part(fg, {"a": [src]})
        with pytest.raises(ValueError, match="two groups"):
            part(fg, {"a": [src, snk], "b": [snk]})


RECEIVER_SCRIPT = r"""
import sys
import numpy as np
from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general, zmq as zb
addr, n, outpath = sys.argv[1], int(sys.argv[2]), sys.argv[3]
fg = Flowgraph(batch_size=512)
src = zb.pull_source(addr, bind=False)
hd = general.head(n)
snk = general.vector_sink()
fg.connect(src, 0, hd, 0)
fg.connect(hd, 0, snk, 0)
fg.run(device="cpu")
np.save(outpath, snk.data())
"""


def _child(script: str, *args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, **kw)


def _reap(child) -> None:
    if child.poll() is None:
        child.kill()
    child.communicate(timeout=JOIN_S)


def test_true_multiprocess_stream(tmp_path):
    """A real process boundary across packages: a port receiver in a child
    process pulls what the JAX package's push_sink (libzmq) sends here,
    bit for bit."""
    data = _cf32(8192, seed=51)
    addr = edge_address()
    out = tmp_path / "rx.npy"
    child = _child(RECEIVER_SCRIPT, addr, len(data), out)
    try:
        fg = JFlowgraph(batch_size=512)
        src = jgen.vector_source(data)
        snk = jzmq.push_sink(addr, bind=True)
        fg.connect(src, 0, snk, 0)
        fg.run()
        rc = child.wait(timeout=JOIN_S)
        assert rc == 0, child.stderr.read().decode()[-2000:]
        got = np.load(out)
    finally:
        _reap(child)
    np.testing.assert_array_equal(got, data)


def test_tags_cross_partition_boundary():
    """Tags emitted in one partition reach a sink in the other with exact
    offsets, values and payloads, in both packages alike."""
    data = _cf32(4096, seed=52)
    meta = {"id": 7}
    tags = [(0, "start", 1.0), (1500, "rich", meta), (4000, "end")]
    got = {}
    for pkg in ("torch", "jax"):
        fg, src, cp, mc, snk, _ = _chain(pkg, data, 0.5, tags=tags)
        rt = _partitioned(pkg, fg, {"head": [src, cp], "tail": [mc, snk]},
                          {"tail": len(data)})
        rt.start()
        _wait(rt)
        np.testing.assert_allclose(snk.data(), data * 0.5, rtol=RTOL)
        got[pkg] = [(t.offset, t.key, float(t.value[0]), t.payload)
                    for t in snk.tags()]
    assert [(o, k) for o, k, _, _ in got["torch"]] == [
        (0, "start"), (1500, "rich"), (4000, "end")]
    assert got["torch"][0][2] == 1.0 and got["torch"][1][3] == meta
    assert got["torch"] == got["jax"]


class _failing_source(Block):
    host_io = True

    def __init__(self, name=None):
        super().__init__(name)
        self.add_output("out", "cf32")
        self.calls = 0

    def host_pull(self, nout):
        self.calls += 1
        if self.calls >= 3:
            raise RuntimeError("boom: synthetic partition failure")
        return np.zeros((nout,), np.complex64)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["host_in"]}


class _jax_failing_source(JBlock):
    host_io = True
    host_pull = _failing_source.host_pull
    work = _failing_source.work

    def __init__(self, name=None):
        super().__init__(name)
        self.add_output("out", "cf32")
        self.calls = 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_partition_failure_aborts_peers_promptly(pkg):
    """A partition dying mid-stream ships abort frames (Runner.abort_peers):
    its peer fails within about a batch, not the 30 s receive timeout, and
    wait() raises the originating error first."""
    FG, gen, src = ((Flowgraph, general, _failing_source()) if pkg == "torch"
                    else (JFlowgraph, jgen, _jax_failing_source()))
    fg = FG(batch_size=512)
    snk = gen.vector_sink()
    fg.connect(src, 0, snk, 0)
    rt = _partitioned(pkg, fg, {"a": [src], "b": [snk]},
                      {"a": 1 << 30, "b": 1 << 30})
    t0 = time.monotonic()
    rt.start()
    with pytest.raises(RuntimeError, match="boom"):
        _wait(rt)
    assert time.monotonic() - t0 < 15


def _xfer_in(rt, part):
    return next(b for b in rt.partitions[part].blocks
                if b.name.startswith("xfer_in"))


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_runtime_stop_aborts_cleanly(pkg):
    """Runtime.stop() ends a running distributed graph without errors,
    once items have crossed the edge."""
    data = _cf32(512, seed=53)
    FG, gen = (Flowgraph, general) if pkg == "torch" else (JFlowgraph, jgen)
    fg = FG(batch_size=512)
    src = gen.vector_source(data, repeat=True)
    cp = gen.copy()
    snk = gen.null_sink()
    fg.connect(src, 0, cp, 0)
    fg.connect(cp, 0, snk, 0)
    rt = _partitioned(pkg, fg, {"a": [src], "b": [cp, snk]},
                      {"a": 1 << 30, "b": 1 << 30})
    rt.start()
    _await(lambda: len(rt._runners) == 2 and _xfer_in(rt, "b")._pos >= 4096,
           "no batches crossed the edge")
    rt.stop()
    t0 = time.monotonic()
    _wait(rt)  # no raise
    assert time.monotonic() - t0 < 10


DYING_RECEIVER_SCRIPT = """
import os, sys
import zmq
addr = sys.argv[1]
ctx = zmq.Context.instance()
sock = ctx.socket(zmq.PULL)
sock.RCVHWM = 1  # tiny buffer: back-pressure reaches the sender fast
sock.connect(addr)
print("ready", flush=True)  # the parent waits for this before streaming
sock.recv()
sock.recv()
os._exit(1)  # hard death mid-stream, no clean close
"""


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_downstream_process_death_raises_upstream(pkg):
    """The DOWNSTREAM process (a libzmq PULL) dies mid-stream: the
    upstream's bounded send raises within seconds, in both packages."""
    addr = edge_address()
    child = _child(DYING_RECEIVER_SCRIPT, addr, text=True)
    try:
        if pkg == "torch":
            fg = Flowgraph(batch_size=2048)
            src = general.vector_source(_cf32(2048, seed=7), repeat=True)
            snk = tzmq.push_sink(addr, bind=True, send_timeout_s=2.0, sndhwm=1)
            fg.connect(src, 0, snk, 0)
            runner = Runner(fg, device="cpu", total_items=1 << 30)
        else:
            fg = JFlowgraph(batch_size=2048)
            src = jgen.vector_source(_cf32(2048, seed=7), repeat=True)
            snk = jzmq.push_sink(addr, bind=True, send_timeout_s=2.0, sndhwm=1)
            fg.connect(src, 0, snk, 0)
            runner = JRunner(fg, total_items=1 << 30)
        assert child.stdout.readline().strip() == "ready"
        runner.start_async()
        child.wait(timeout=JOIN_S)
        t0 = time.monotonic()
        runner._thread.join(JOIN_S)
        assert not runner._thread.is_alive()
        with pytest.raises(RuntimeError, match="accepted no data"):
            runner.wait()
        assert time.monotonic() - t0 < 5
    finally:
        _reap(child)


def test_remote_control_set_param_mid_stream_threads():
    """A client changes a multiply_const's k in a RUNNING partition through
    its ControlServer, once the first batch has crossed the edge: the
    output switches value once, at a batch boundary. The port's client
    drives the port's server, the JAX package's its own."""
    n = 40960
    for pkg, client in (("torch", RuntimeClient), ("jax", JClient)):
        fg, src, cp, mc, snk, thr = _chain(
            pkg, np.ones(1024, np.complex64), 2.0 + 0.0j, repeat=True,
            throttle=40000.0, name="mc_remote")
        addr = edge_address()
        rt = _partitioned(pkg, fg, {"dsp": [src, cp, thr, mc],
                                    "collect": [snk]},
                          {"collect": n, "dsp": n},
                          control_addresses={"dsp": addr})
        rt.start()
        ctl = client(addr)
        try:
            ctl.ping()
            if pkg == "torch":
                assert _xfer_in(rt, "collect").first_batch.wait(JOIN_S)
            else:
                _await(lambda: _xfer_in(rt, "collect")._pos > 0, "no batch")
            assert complex(ctl.get_param("mc_remote", "k")) == 2.0
            ctl.set_param("mc_remote", "k", 5.0 + 0.0j)
            _wait(rt)
        finally:
            ctl.close()
        got = np.real(snk.data())
        assert got.shape == (n,)
        assert got[0] == 2.0 and got[-1] == 5.0, (pkg, got[0], got[-1])
        assert set(np.unique(got).tolist()) == {2.0, 5.0}
        assert len(np.nonzero(np.diff(got))[0]) == 1
        assert np.nonzero(np.diff(got))[0][0] % 512 == 511  # a batch boundary


CONTROLLED_SENDER = r"""
import sys
import numpy as np
from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general, math as gmath, zmq as zb
from newsched_tpu_torch.runtime.distributed import Runtime

data_addr, ctl_addr, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
fg = Flowgraph(batch_size=512)
src = general.vector_source(np.ones(1024, np.complex64), repeat=True)
thr = general.throttle(60000.0)
mc = gmath.multiply_const(2.0 + 0.0j, dtype="cf32", name="mc_remote")
snk = zb.push_sink(data_addr, bind=True, name="push0")
fg.connect(src, 0, thr, 0)
fg.connect(thr, 0, mc, 0)
fg.connect(mc, 0, snk, 0)
Runtime({"dsp": fg}, total_items={"dsp": n},
        control_addresses={"dsp": ctl_addr}, device="cpu").run()
"""


def test_remote_control_true_multiprocess():
    """A real process boundary: the parent retunes a block running in a
    CHILD process mid-stream, once it holds the stream's first batch (no
    sleep decides when), and the received stream switches value once."""
    data_addr, ctl_addr = edge_address(), edge_address()
    n = 30720
    child = _child(CONTROLLED_SENDER, data_addr, ctl_addr, n)
    try:
        fg = Flowgraph(batch_size=512)
        src = tzmq.pull_source(data_addr, bind=False, timeout_s=JOIN_S)
        hd = general.head(n)
        snk = general.vector_sink()
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        runner = fg.start(device="cpu")
        ctl = RuntimeClient(ctl_addr, timeout_ms=JOIN_S * 1000)
        try:
            ctl.ping()
            assert src.first_batch.wait(JOIN_S), "no first batch"
            ctl.set_param("mc_remote", "k", 7.0 + 0.0j)
        finally:
            ctl.close()
        runner._thread.join(JOIN_S)
        assert not runner._thread.is_alive()
        fg.wait()
        assert child.wait(timeout=JOIN_S) == 0, child.stderr.read()[-2000:]
        got = np.real(snk.data())
        assert got[0] == 2.0 and got[-1] == 7.0, (got[0], got[-1])
        assert set(np.unique(got).tolist()) == {2.0, 7.0}
        assert len(np.nonzero(np.diff(got))[0]) == 1
    finally:
        _reap(child)


def test_control_plane_hmac_auth():
    """With a shared auth_key, frames are checked BEFORE deserialization:
    an unkeyed client, a wrong-keyed one and the JAX package's keyed client
    (whose frames lack the replay guard) are refused; the keyed port client
    works before and after."""
    addr = edge_address()
    mc = gmath.multiply_const(2.0, dtype="rf32", name="mc_auth")
    srv = ControlServer(addr, lambda: None,
                        lambda n: mc if n == "mc_auth" else None,
                        auth_key=b"sekrit")
    try:
        good = RuntimeClient(addr, timeout_ms=5000, auth_key=b"sekrit")
        good.ping()
        good.set_param("mc_auth", "k", 7.0)
        assert float(good.get_param("mc_auth", "k")) == 7.0
        for bad in (RuntimeClient(addr, timeout_ms=5000),
                    RuntimeClient(addr, timeout_ms=5000, auth_key=b"other"),
                    JClient(addr, timeout_ms=5000, auth_key=b"sekrit")):
            with pytest.raises(RuntimeError):
                bad.set_param("mc_auth", "k", 1.0)
            bad.close()
        assert float(good.get_param("mc_auth", "k")) == 7.0
        good.close()
    finally:
        srv.close()


def test_jax_partition_feeds_port_partition():
    """Across packages on one edge: a JAX partition's push_sink (libzmq)
    feeds a port partition's pull_source (the port's ZMTP), tags and all;
    the port's sink equals the JAX package's unsplit graph within RTOL."""
    data = _cf32(4096, seed=54)
    tags = [(0, "start", 1.0), (2000, "mid", {"n": 2})]
    addr = edge_address()
    jfg = JFlowgraph(batch_size=512)
    jsrc = jgen.vector_source(data, tags=tags)
    jcp = jgen.copy()
    jfg.connect(jsrc, 0, jcp, 0)
    jfg.connect(jcp, 0, jzmq.push_sink(addr, bind=True), 0)
    tfg = Flowgraph(batch_size=512)
    tsrc = tzmq.pull_source(addr, bind=False, tag_capacity=4)
    mc = gmath.multiply_const(2.0 + 1.0j, dtype="cf32")
    snk = general.vector_sink()
    tfg.connect(tsrc, 0, mc, 0)
    tfg.connect(mc, 0, snk, 0)
    rt = Runtime({"tail": tfg}, total_items={"tail": len(data)}, device="cpu")
    rt.start()
    jfg.run()
    _wait(rt)
    ref, _, _, _, rsnk, _ = _chain("jax", data, 2.0 + 1.0j, tags=tags)
    ref.run()
    np.testing.assert_allclose(snk.data(), rsnk.data(), rtol=RTOL)
    assert [(t.offset, t.key, t.payload) for t in snk.tags()] == [
        (t.offset, t.key, t.payload) for t in rsnk.tags()]


def test_jax_client_drives_port_server():
    """Unkeyed, the wire is the reference's pickle: a JAX RuntimeClient
    (libzmq REQ) pings, reads, sets and posts to a port ControlServer, and
    the port's client drives it too."""
    addr = edge_address()
    mc = gmath.multiply_const(2.0, dtype="rf32", name="mc_x")
    got = []
    fwd = gmath.multiply_const(1.0, dtype="rf32", name="fwd_x")
    fwd.add_msg_port_in("in", got.append)

    class _runner:  # delivers a message at once, as a runner's drain would
        def enqueue_msg(self, block, port, msg):
            block._msg_handlers[port](msg)

    runner = _runner()
    srv = ControlServer(addr, lambda: runner, {"mc_x": mc, "fwd_x": fwd}.get)
    try:
        for client in (JClient(addr, timeout_ms=5000),
                       RuntimeClient(addr, timeout_ms=5000)):
            client.ping()
            client.set_param("mc_x", "k", 3.0)
            assert float(client.get_param("mc_x", "k")) == 3.0
            client.post_msg("fwd_x", "in", {"cmd": "retune"})
            with pytest.raises(RuntimeError, match="no block"):
                client.set_param("nope", "k", 1.0)
            client.close()
        assert got == [{"cmd": "retune"}] * 2
    finally:
        srv.close()


@pytest.mark.parametrize("address,exposed", [
    ("tcp://localhost.example.com:5701", True),
    ("tcp://10.0.0.5:5701", True),
    ("tcp://*:5701", True),
    ("tcp://127.0.0.1.example.com:5701", True),
    ("tcp://127.0.0.2:5701", False),
    ("tcp://[::1]:5701", False),
    ("tcp://localhost:5701", False),
    ("ipc:///tmp/ctl.ipc", False),
    ("ipc://ctl-10.0.0.5", False),
])
def test_exposed_addresses_warn(address, exposed, caplog):
    """The loopback check parses the host exactly (the reference looks for
    substrings): an unkeyed server warns on every host but loopback, and
    never on ipc://; a keyed one never warns."""
    with caplog.at_level(logging.WARNING, logger="newsched_tpu_torch.control"):
        control._warn_if_exposed(address, None)
        control._warn_if_exposed(address, b"key")
    warned = [r for r in caplog.records if "WITHOUT auth_key" in r.message]
    assert len(warned) == (1 if exposed else 0)
    assert control.is_loopback(address) is not exposed


class _Touch:
    """Unpickling this creates ``path``: a stand-in for code a forged
    frame would run."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_replayed_keyed_frame_refused(tmp_path):
    """A keyed request's exact bytes sent again are refused before they
    act (its counter is not above its session's last), a frame without the
    key is never unpickled, and each reply names its request."""
    addr = edge_address()
    mc = gmath.multiply_const(2.0, dtype="rf32", name="mc_r")
    key = b"replay-key"
    srv = ControlServer(addr, lambda: None, {"mc_r": mc}.get, auth_key=key)
    raw = zmtp.Socket(zmtp.REQ)
    raw.setsockopt(zmtp.RCVTIMEO, 5000)
    raw.setsockopt(zmtp.SNDTIMEO, 5000)
    raw.connect(addr)
    session = os.urandom(16)

    def ask(frame):
        raw.send(frame)
        return raw.recv()

    try:
        frame = control.request_frame(
            {"op": "set_param", "block": "mc_r", "param": "k", "value": 7.0},
            key, session, 1)
        reply = control._unseal(ask(frame), key)
        assert control._split_guard(reply)[:2] == (session, 1)
        assert float(mc.get_param("k")) == 7.0
        mc.set_param("k", 3.0)
        refused = pickle.loads(ask(frame))  # the same bytes again
        assert not refused["ok"] and "replayed" in refused["error"]
        assert float(mc.get_param("k")) == 3.0
        later = control.request_frame({"op": "ping"}, key, session, 5)
        assert control._split_guard(control._unseal(ask(later), key))[1] == 5
        again = control.request_frame({"op": "ping"}, key, session, 4)
        assert not pickle.loads(ask(again))["ok"]
        canary = tmp_path / "unpickled"
        forged = control.request_frame({"op": "ping", "x": _Touch(str(canary))},
                                       None, session, 9)
        assert not pickle.loads(ask(forged))["ok"]
        assert not canary.exists()
    finally:
        raw.close(0)
        srv.close()
