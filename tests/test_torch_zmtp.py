"""The port's ZMTP 3.0 transport (newsched_tpu_torch/io/zmtp.py) against
libzmq through pyzmq, which stays only as the peer that proves the wire:
each socket pair in both bind directions over tcp:// and ipc://, a long
frame, connect before bind, NOBLOCK's Again, a stopped reader, and the
ZMQ blocks, the distributed runtime and the control plane run with
``zmq`` blocked from import, as on the card's machine."""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import zmq

from newsched_tpu_torch.blocks import zmq as tzmq
from newsched_tpu_torch.io import zmtp
from newsched_tpu_torch.runtime.block import StreamAborted
from newsched_tpu_torch.runtime.distributed import edge_address

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_MS = 10_000  # the longest any receive here waits


def _address(transport: str) -> str:
    if transport == "ipc":
        return edge_address()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://127.0.0.1:{port}"


def _pyzmq(kind: int, **opts):
    s = zmq.Context.instance().socket(kind)
    s.setsockopt(zmq.LINGER, 0)
    s.setsockopt(zmq.RCVTIMEO, TIMEOUT_MS)
    s.setsockopt(zmq.SNDTIMEO, TIMEOUT_MS)
    for k, v in opts.items():
        s.setsockopt(getattr(zmq, k), v)
    return s


def _port(kind: str):
    s = zmtp.Socket(kind)
    s.setsockopt(zmtp.RCVTIMEO, TIMEOUT_MS)
    s.setsockopt(zmtp.SNDTIMEO, TIMEOUT_MS)
    return s


def _join(a, b, address: str, a_binds: bool) -> None:
    """Bind one of a, b at ``address`` and connect the other to it."""
    (a if a_binds else b).bind(address)
    (b if a_binds else a).connect(address)


def _close(*socks) -> None:
    for s in socks:
        s.close(0)


BIND_CASES = [(t, port_sends, port_binds) for t in ("tcp", "ipc")
              for port_sends in (True, False) for port_binds in (True, False)]


@pytest.mark.parametrize("transport,port_sends,port_binds", BIND_CASES)
def test_push_pull_with_pyzmq(transport, port_sends, port_binds):
    """PUSH -> PULL, the port on either end, either end bound: every
    message arrives, in order, short and long."""
    addr = _address(transport)
    if port_sends:
        tx, rx = _port(zmtp.PUSH), _pyzmq(zmq.PULL)
    else:
        tx, rx = _pyzmq(zmq.PUSH), _port(zmtp.PULL)
    try:
        _join(tx, rx, addr, a_binds=port_sends == port_binds)
        msgs = [b"", b"x", bytes(range(256)) * 3, os.urandom(300_000)]
        for m in msgs:
            tx.send(m)
        assert [bytes(rx.recv()) for _ in msgs] == msgs
    finally:
        _close(tx, rx)


@pytest.mark.parametrize("transport,port_sends,port_binds", BIND_CASES)
def test_pub_sub_with_pyzmq(transport, port_sends, port_binds):
    """XPUB -> SUB, the port on either end, either end bound: the publisher
    sees the subscription (3.0's message form), the subscriber gets the
    matching topic only."""
    addr = _address(transport)
    if port_sends:
        tx, rx = _port(zmtp.XPUB), _pyzmq(zmq.SUB)
        rx.setsockopt(zmq.SUBSCRIBE, b"ab")
    else:
        tx, rx = _pyzmq(zmq.XPUB), _port(zmtp.SUB)
        rx.setsockopt(zmtp.SUBSCRIBE, b"ab")
    try:
        _join(tx, rx, addr, a_binds=port_sends == port_binds)
        deadline = time.monotonic() + TIMEOUT_MS / 1e3
        while not tx.poll(20):  # libzmq attaches a connection to a socket
            rx.poll(0)          # (and a SUB sends its topics) at its next call
            assert time.monotonic() < deadline, "no subscription arrived"
        assert bytes(tx.recv()) == b"\x01ab"
        for m in (b"zz-dropped", b"ab-1", b"xab-dropped", b"ab-2" * 100):
            tx.send(m)
        assert bytes(rx.recv()) == b"ab-1"
        assert bytes(rx.recv()) == b"ab-2" * 100
    finally:
        _close(tx, rx)


def test_plain_pub_sends_to_pyzmq_subscriber():
    """A plain PUB (no XPUB): the port publishes until the libzmq
    subscriber, whose subscription arrives in the background, holds one."""
    addr = _address("tcp")
    tx, rx = _port(zmtp.PUB), _pyzmq(zmq.SUB, SUBSCRIBE=b"")
    try:
        _join(tx, rx, addr, a_binds=True)
        deadline = time.monotonic() + TIMEOUT_MS / 1e3
        while not rx.poll(20):
            assert time.monotonic() < deadline, "the PUB never reached its SUB"
            tx.send(b"tick")
        assert rx.recv() == b"tick"
    finally:
        _close(tx, rx)


@pytest.mark.parametrize("transport,port_asks,port_binds", BIND_CASES)
def test_req_rep_with_pyzmq(transport, port_asks, port_binds):
    """REQ <-> REP, the port on either end, either end bound: requests and
    replies alternate through the envelope."""
    addr = _address(transport)
    if port_asks:
        req, rep = _port(zmtp.REQ), _pyzmq(zmq.REP)
    else:
        req, rep = _pyzmq(zmq.REQ), _port(zmtp.REP)
    try:
        _join(req, rep, addr, a_binds=port_asks == port_binds)
        for i in range(3):
            req.send(b"ask %d" % i)
            assert bytes(rep.recv()) == b"ask %d" % i
            rep.send(b"answer %d" % i)
            assert bytes(req.recv()) == b"answer %d" % i
    finally:
        _close(req, rep)


def test_rep_answers_each_asker():
    """One port REP, a port REQ and a libzmq REQ: each reply goes to the
    peer that asked."""
    addr = _address("ipc")
    rep, a, b = _port(zmtp.REP), _port(zmtp.REQ), _pyzmq(zmq.REQ)
    try:
        rep.bind(addr)
        a.connect(addr)
        b.connect(addr)
        a.send(b"from a")
        b.send(b"from b")
        for _ in range(2):
            who = bytes(rep.recv())
            rep.send(b"to " + who[-1:])
        assert bytes(a.recv()) == b"to a"
        assert b.recv() == b"to b"
    finally:
        _close(rep, a, b)


@pytest.mark.parametrize("port_sends", [True, False])
def test_long_frame_4mb(port_sends):
    """A 4 MB frame (8-byte size, LONG) each way."""
    addr = _address("tcp")
    big = np.random.default_rng(3).integers(0, 256, 4 << 20, np.uint8).tobytes()
    tx, rx = ((_port(zmtp.PUSH), _pyzmq(zmq.PULL)) if port_sends
              else (_pyzmq(zmq.PUSH), _port(zmtp.PULL)))
    try:
        _join(tx, rx, addr, a_binds=True)
        tx.send(big)
        assert bytes(rx.recv()) == big
    finally:
        _close(tx, rx)


@pytest.mark.parametrize("peer", ["pyzmq", "port"])
def test_connect_before_bind(peer):
    """The port connects before anyone binds; the connection is made in
    the background once the peer binds, and a REQ sent before then waits
    for it."""
    addr = _address("ipc")
    rx = _port(zmtp.PULL)
    req = _port(zmtp.REQ)
    rx.connect(addr)
    rep_addr = _address("ipc")
    req.connect(rep_addr)
    asked = threading.Thread(target=req.send, args=(b"early",), daemon=True)
    asked.start()
    if peer == "pyzmq":
        tx, rep = _pyzmq(zmq.PUSH), _pyzmq(zmq.REP)
    else:
        tx, rep = _port(zmtp.PUSH), _port(zmtp.REP)
    try:
        tx.bind(addr)
        rep.bind(rep_addr)
        tx.send(b"late bind")
        assert bytes(rx.recv()) == b"late bind"
        assert bytes(rep.recv()) == b"early"
        asked.join(TIMEOUT_MS / 1e3)
        assert not asked.is_alive()
        rep.send(b"ok")
        assert bytes(req.recv()) == b"ok"
    finally:
        _close(rx, req, tx, rep)


def test_noblock_with_no_peer_raises_again():
    """A PUSH with no peer never drops: NOBLOCK raises Again, a send with
    SNDTIMEO raises Again when it passes, poll(POLLOUT) reports nothing;
    the message goes once a peer connects."""
    addr = _address("tcp")
    tx = zmtp.Socket(zmtp.PUSH)
    tx.bind(addr)
    rx = _pyzmq(zmq.PULL)
    try:
        with pytest.raises(zmtp.Again):
            tx.send(b"nobody", zmtp.NOBLOCK)
        tx.setsockopt(zmtp.SNDTIMEO, 50)
        t0 = time.monotonic()
        with pytest.raises(zmtp.Again):
            tx.send(b"nobody")
        assert time.monotonic() - t0 >= 0.04
        assert tx.poll(10, zmtp.POLLOUT) == 0
        rx.connect(addr)
        assert tx.poll(TIMEOUT_MS, zmtp.POLLOUT) == zmtp.POLLOUT
        tx.send(b"somebody", zmtp.NOBLOCK)
        assert rx.recv() == b"somebody"
    finally:
        _close(tx, rx)


def test_stopped_reader_blocks_sender_which_still_aborts():
    """A libzmq reader that stops reading: the port's push_sink fills its
    SNDHWM and the transport, then blocks (Again under NOBLOCK); its
    blocking send still ends on request_abort within a few _POLL_MS."""
    addr = _address("tcp")
    rx = _pyzmq(zmq.PULL, RCVHWM=1)
    snk = tzmq.push_sink(addr, bind=True, dtype="rf32", sndhwm=1)
    snk.start()
    try:
        rx.connect(addr)
        assert snk._sock.poll(TIMEOUT_MS, zmtp.POLLOUT)
        payload = tzmq._encode_batch(np.zeros(1 << 18, np.float32))
        sent, deadline = 0, time.monotonic() + 30
        while True:  # until the reader's stop reaches the sender
            try:
                snk._sock.send(payload, zmtp.NOBLOCK)
                sent += 1
            except zmtp.Again:
                if not snk._sock.poll(200, zmtp.POLLOUT):
                    break
            assert time.monotonic() < deadline, f"never blocked ({sent} sent)"
        errors, done = [], threading.Event()

        def blocked_send():
            try:
                snk._send(payload)
            except StreamAborted as e:
                errors.append(e)
            done.set()

        t = threading.Thread(target=blocked_send, daemon=True)
        t.start()
        assert not done.wait(0.3), "the send did not block"
        t0 = time.monotonic()
        snk.request_abort()
        assert done.wait(5)
        assert time.monotonic() - t0 < 3 * tzmq._POLL_MS / 1e3 + 0.2
        assert len(errors) == 1 and sent >= 1
    finally:
        snk.stop()
        rx.close(0)


def test_rcvhwm_bounds_what_a_port_reader_holds():
    """A port PULL that is not read holds at most RCVHWM messages; with
    the sender's SNDHWM of 1 the sender blocks after a few 1 MB messages
    (the unix socket's buffers take the rest), not after the default
    1000, and every message then arrives in order."""
    addr = _address("ipc")
    tx, rx = _port(zmtp.PUSH), _port(zmtp.PULL)
    tx.setsockopt(zmtp.SNDHWM, 1)
    rx.setsockopt(zmtp.RCVHWM, 1)
    try:
        _join(tx, rx, addr, a_binds=True)
        assert tx.poll(TIMEOUT_MS, zmtp.POLLOUT)
        sent, deadline = [], time.monotonic() + 30
        while True:  # until the reader's bound reaches the sender
            msg = bytes([len(sent) % 256]) * (1 << 20)
            try:
                tx.send(msg, zmtp.NOBLOCK)
                sent.append(msg)
            except zmtp.Again:
                if not tx.poll(300, zmtp.POLLOUT):
                    break
            assert time.monotonic() < deadline, f"never blocked ({len(sent)})"
        assert 2 <= len(sent) <= 8, len(sent)
        assert len(rx._inbox) == 1
        for msg in sent:
            assert rx.recv() == msg
    finally:
        _close(tx, rx)


def test_close_flushes_within_linger():
    """close(linger) sends what is queued first: messages held back by a
    slow reader all reach it, the last (an EOF's place) included, and
    close returns once they have left."""
    addr = _address("ipc")
    tx = zmtp.Socket(zmtp.PUSH)
    tx.bind(addr)
    rx = _pyzmq(zmq.PULL, RCVHWM=1)
    rx.connect(addr)
    msgs = [bytes([i]) * (1 << 20) for i in range(16)]
    closed = threading.Event()

    def close():
        tx.close(linger=TIMEOUT_MS)
        closed.set()

    closer = threading.Thread(target=close, daemon=True)
    try:
        for m in msgs:
            tx.send(m)
        closer.start()
        assert [rx.recv() for _ in msgs] == msgs
        assert closed.wait(TIMEOUT_MS / 1e3)
    finally:
        if not closer.is_alive():
            tx.close(0)
        rx.close(0)


def test_bad_peer_is_refused():
    """A peer that does not speak ZMTP is dropped at its greeting; the
    socket goes on serving real peers."""
    addr = _address("tcp")
    rx = _port(zmtp.PULL)
    rx.bind(addr)
    host, port = addr[len("tcp://"):].split(":")
    tx = _pyzmq(zmq.PUSH)
    try:
        with socket.create_connection((host, int(port)), 5) as s:
            s.settimeout(5)
            s.sendall(b"GET / HTTP/1.0\r\n\r\n" + bytes(64))
            assert s.recv(1)[:1] == b"\xff"  # our greeting, then the drop
            while s.recv(1 << 16):  # a timeout here: never dropped
                pass
        tx.connect(addr)
        tx.send(b"still here")
        assert bytes(rx.recv()) == b"still here"
    finally:
        _close(rx, tx)


NO_ZMQ = r"""
import sys
sys.modules["zmq"] = None
import numpy as np
from newsched_tpu_torch import Flowgraph
from newsched_tpu_torch.blocks import general, math as gmath
from newsched_tpu_torch.runtime.control import ControlServer, RuntimeClient
from newsched_tpu_torch.runtime.distributed import (Runtime, edge_address,
                                                    partition_flowgraph)

data = (np.arange(2048) % 13).astype(np.complex64)
fg = Flowgraph(batch_size=256)
src = general.vector_source(data, tags=[(0, "start"), (1000, "mid")])
mc = gmath.multiply_const(2.0 + 0j, "cf32", name="mc")
snk = general.vector_sink()
fg.connect(src, 0, mc, 0)
fg.connect(mc, 0, snk, 0)
parts = partition_flowgraph(fg, {"a": [src], "b": [mc, snk]})
ctl = edge_address()
rt = Runtime(parts, total_items={"b": len(data)}, control_addresses={"b": ctl},
             control_auth_key=b"k", device="cpu")
client = RuntimeClient(ctl, auth_key=b"k")
client.ping()
assert complex(client.get_param("mc", "k")) == 2.0
client.close()
rt.run()
np.testing.assert_array_equal(snk.data(), data * 2)
assert [(t.offset, t.key) for t in snk.tags()] == [(0, "start"), (1000, "mid")]
assert sys.modules["zmq"] is None
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "newsched_tpu"))
assert not bad, bad
print("ok")
"""


def test_blocks_runtime_and_control_run_without_zmq():
    """With ``zmq`` blocked from import, as on the card's machine: a
    partitioned graph with tags over the ZMQ blocks and a keyed control
    server, driven by a client, runs and gives the graph's output."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", NO_ZMQ], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stdout[-2000:] + r.stderr[-4000:]


def test_port_sources_name_no_zmq_import():
    """No module of the port, nor chip_smoke.py, imports pyzmq."""
    import ast
    from pathlib import Path

    pkg = Path(ROOT) / "newsched_tpu_torch"
    for path in list(pkg.rglob("*.py")) + [Path(ROOT) / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "zmq" for n in names), (path, names)
