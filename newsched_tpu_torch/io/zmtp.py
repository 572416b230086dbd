"""ZMTP 3.0, the wire protocol libzmq speaks on TCP and IPC sockets, in
Python: the port's ZMQ transport, with no libzmq and no pyzmq.

It takes the surface that ``blocks/zmq.py``, ``runtime/distributed.py``
and ``runtime/control.py`` call, and nothing more:

    s = Socket("PUSH")                  # PUSH PULL PUB XPUB SUB REQ REP
    s.setsockopt(SNDHWM, 4)             # SNDHWM RCVHWM SUBSCRIBE RCVTIMEO SNDTIMEO LINGER
    s.bind("tcp://127.0.0.1:5701")      # or connect(); tcp://host:port, ipc://path
    s.send(data, NOBLOCK)               # raises Again when it cannot send now
    s.poll(100, POLLOUT)                # the ready events among the asked ones
    s.recv()                            # one message's (first) frame, bytes
    s.close(linger=1000)

The wire (https://rfc.zeromq.org/spec/23/): a 64-byte greeting announcing
version 3.0 and the NULL mechanism, sent whole before the peer's is read
(libzmq sends its first 10 bytes and waits for ours); a READY command
whose metadata carries ``Socket-Type`` (and ``Identity`` from a REQ), each
property a 1-byte name length and a 4-byte big-endian value length; then
frames of a flags byte (MORE 1, LONG 2, COMMAND 4) and a 1-byte size, or
an 8-byte big-endian one when LONG. Announcing 3.0 makes a libzmq peer
send subscriptions as messages (``\\x01`` or ``\\x00`` and the topic); 3.1's
SUBSCRIBE and CANCEL commands are taken too. A REQ puts an empty delimiter
frame before its request; a REP answers the peer that asked, behind the
same envelope.

Each connection has a reader thread and a writer thread; a socket's
peers, its queue of received messages and each peer's queue of messages
to send share one condition variable. The semantics are libzmq's where a
caller can see them: ``connect`` before the peer's ``bind`` works (the
connection is retried in the background, and again after a peer goes);
a PUSH or a REQ with no peer, or whose peers each hold SNDHWM messages,
blocks, or raises ``Again`` under NOBLOCK or past SNDTIMEO, and never
drops a message; a PUB drops for a peer whose queue is full or that did
not subscribe; a socket stops reading a peer while it holds RCVHWM
received messages, so a reader that stops blocks its sender through the
transport. ``close`` waits up to ``linger`` ms for queued messages to
leave (-1: until they have left or their peers have gone).
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import threading
import time

NOBLOCK = 1
POLLIN, POLLOUT = 1, 2
PUSH, PULL, PUB, XPUB, SUB, REQ, REP = (
    "PUSH", "PULL", "PUB", "XPUB", "SUB", "REQ", "REP")
SNDHWM, RCVHWM, SUBSCRIBE, RCVTIMEO, SNDTIMEO, LINGER = (
    "SNDHWM", "RCVHWM", "SUBSCRIBE", "RCVTIMEO", "SNDTIMEO", "LINGER")

_MORE, _LONG, _COMMAND = 1, 2, 4
_RECONNECT_S = 0.05     # between attempts of a connecting socket
_HANDSHAKE_S = 30.0     # the longest a greeting and READY may take
_JOIN_S = 2.0           # the longest close() waits for each of its threads
# socket type -> the peer types it talks to (ZMTP 3.0's table)
_PEERS = {PUSH: {"PULL"}, PULL: {"PUSH"}, PUB: {"SUB", "XSUB"},
          XPUB: {"SUB", "XSUB"}, SUB: {"PUB", "XPUB"},
          REQ: {"REP", "ROUTER"}, REP: {"REQ", "DEALER"}}
_GREETING = (b"\xff" + bytes(8) + b"\x7f" + bytes([3, 0])
             + b"NULL".ljust(20, b"\x00") + b"\x00" + bytes(31))


class Again(BlockingIOError):
    """The call cannot complete now: NOBLOCK, or its time limit passed."""


class ZMTPError(ConnectionError):
    """A peer broke the protocol, or the socket is closed."""


def _endpoint(address: str, bind: bool):
    """(family, socket address, ipc path or None) of tcp://host:port or
    ipc://path; tcp://*:port binds every interface. Names resolve to
    IPv4, as libzmq's do by default."""
    scheme, sep, rest = address.partition("://")
    if not sep or scheme not in ("tcp", "ipc"):
        raise ValueError(f"{address!r}: only tcp://host:port and ipc://path")
    if scheme == "ipc":
        return socket.AF_UNIX, rest, rest
    host, _, port = rest.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    if host in ("*", "") and bind:
        return socket.AF_INET, ("0.0.0.0", int(port)), None
    if ":" in host:
        return socket.AF_INET6, (host, int(port)), None
    info = socket.getaddrinfo(host, int(port), socket.AF_INET,
                              socket.SOCK_STREAM)
    return socket.AF_INET, info[0][4], None


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ZMTPError("peer closed the connection")
        got += k
    return buf


def _frame_head(flags: int, size: int) -> bytes:
    if size > 255:
        return struct.pack(">BQ", flags | _LONG, size)
    return struct.pack(">BB", flags, size)


def _command(name: bytes, data: bytes = b"") -> bytes:
    body = bytes([len(name)]) + name + data
    return _frame_head(_COMMAND, len(body)) + body


def _read_frame(sock: socket.socket) -> tuple[int, bytes]:
    flags, size = _recv_exact(sock, 2)
    if flags & _LONG:
        size = struct.unpack(">Q", bytes([size]) + _recv_exact(sock, 7))[0]
    return flags, bytes(_recv_exact(sock, size)) if size else b""


def _handshake(sock: socket.socket, kind: str) -> None:
    """Greetings both ways, then READY both ways; raises ZMTPError if the
    peer is no ZMTP 3 NULL peer of a matching socket type."""
    sock.sendall(_GREETING)
    g = _recv_exact(sock, 64)
    if g[0] != 0xFF or not g[9] & 1:
        raise ZMTPError("the peer's greeting is not ZMTP's")
    if g[10] < 3:
        raise ZMTPError(f"the peer speaks ZMTP {g[10]}.{g[11]}; 3 is needed")
    if bytes(g[12:32]).rstrip(b"\x00") != b"NULL":
        raise ZMTPError(f"the peer asks for mechanism {bytes(g[12:32])!r}; "
                        "only NULL is spoken")
    props = [(b"Socket-Type", kind.encode())]
    if kind == REQ:
        props.append((b"Identity", b""))
    meta = b"".join(bytes([len(k)]) + k + struct.pack(">I", len(v)) + v
                    for k, v in props)
    sock.sendall(_command(b"READY", meta))
    flags, body = _read_frame(sock)
    name = body[1:1 + body[0]] if body else b""
    if not flags & _COMMAND or name != b"READY":
        raise ZMTPError(f"expected READY from the peer, got {body[:40]!r}")
    i, peer_props = 1 + body[0], {}
    while i < len(body):
        n = body[i]
        key = body[i + 1:i + 1 + n].decode("ascii", "replace").lower()
        (vlen,) = struct.unpack(">I", body[i + 1 + n:i + 5 + n])
        peer_props[key] = body[i + 5 + n:i + 5 + n + vlen]
        i += 5 + n + vlen
    peer_kind = peer_props.get("socket-type", b"").decode("ascii", "replace")
    if peer_kind not in _PEERS[kind]:
        raise ZMTPError(f"a {kind} socket cannot talk to a {peer_kind!r} peer")


class _Peer:
    """One live connection: its raw socket, the messages queued for it
    (each a list of frames; the head stays queued while it is written, so
    it counts against SNDHWM), and a PUB's record of its subscriptions."""

    def __init__(self, raw: socket.socket):
        self.raw = raw
        self.out: collections.deque = collections.deque()
        self.subs: list[bytes] = []
        self.alive = True


class Socket:
    """A ZMQ socket of type ``kind`` (PUSH, PULL, PUB, XPUB, SUB, REQ,
    REP) that speaks ZMTP 3.0 itself; see the module docstring."""

    def __init__(self, kind: str):
        if kind not in _PEERS:
            raise ValueError(f"socket type {kind!r}: one of {sorted(_PEERS)}")
        self.kind = kind
        self._cond = threading.Condition()
        self._peers: list[_Peer] = []
        self._inbox: collections.deque = collections.deque()  # (peer, envelope, frames)
        self._opts = {SNDHWM: 1000, RCVHWM: 1000, RCVTIMEO: -1, SNDTIMEO: -1,
                      LINGER: -1}
        self._topics: list[bytes] = []            # a SUB's subscriptions
        self._subscribed: collections.Counter = collections.Counter()  # a PUB's
        self._rr = 0                              # round robin over peers
        self._asked: _Peer | None = None          # REQ: the peer owing a reply
        self._answer: tuple | None = None         # REP: (peer, envelope) to answer
        self._closed = False
        self._closing = threading.Event()
        self._raws: set[socket.socket] = set()
        self._listeners: list[tuple[socket.socket, str | None]] = []
        self._threads: list[threading.Thread] = []

    # -- set-up ------------------------------------------------------------
    def setsockopt(self, option: str, value) -> None:
        if option == SUBSCRIBE:
            if self.kind != SUB:
                raise ValueError("SUBSCRIBE is a SUB socket's option")
            topic = bytes(value)
            with self._cond:
                self._topics.append(topic)
                for p in self._peers:
                    p.out.append([b"\x01" + topic])
                self._cond.notify_all()
        elif option in self._opts:
            self._opts[option] = int(value)
        else:
            raise ValueError(f"unknown socket option {option!r}")

    def bind(self, address: str) -> None:
        family, where, path = _endpoint(address, bind=True)
        ls = socket.socket(family, socket.SOCK_STREAM)
        try:
            if path is None:
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            else:
                try:  # a stale endpoint of a process gone, as libzmq does
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            ls.bind(where)
            ls.listen(64)
        except OSError:
            ls.close()
            raise
        with self._cond:
            self._check_open()
            self._listeners.append((ls, path))
        self._spawn(self._accept, ls, name=f"zmtp-{self.kind}-accept")

    def connect(self, address: str) -> None:
        _endpoint(address, bind=False)  # refuse a malformed address now
        with self._cond:
            self._check_open()
        self._spawn(self._connector, address, name=f"zmtp-{self.kind}-connect")

    # -- messages ------------------------------------------------------------
    def send(self, data, flags: int = 0) -> None:
        """Queue one single-frame message (bytes-like). Raises Again when
        it cannot be queued now under NOBLOCK, or within SNDTIMEO."""
        if self.kind in (PULL, SUB):
            raise ZMTPError(f"a {self.kind} socket does not send")
        with self._cond:
            self._check_open()
            if self.kind in (PUB, XPUB):
                for p in self._peers:
                    if len(p.out) < self._opts[SNDHWM] and any(
                            data[:len(t)] == t for t in p.subs):
                        p.out.append([data])
                self._cond.notify_all()
                return
            if self.kind == REQ and self._asked is not None:
                raise ZMTPError("a REQ socket sends again only after its reply")
            if self.kind == REP:  # to the asker, unless it has gone
                if self._answer is None:
                    raise ZMTPError("a REP socket sends only a reply to a request")
                peer, envelope = self._answer
                self._answer = None
                if peer.alive:
                    peer.out.append(envelope + [data])
                self._cond.notify_all()
                return
            deadline = self._deadline(SNDTIMEO)
            while (peer := self._pick()) is None:
                self._wait(flags, deadline)
            peer.out.append([b"", data] if self.kind == REQ else [data])
            if self.kind == REQ:
                self._asked = peer
            self._cond.notify_all()

    def recv(self, flags: int = 0) -> bytes:
        """The next message's first frame (past a REQ/REP envelope). Raises
        Again when none is there under NOBLOCK, or within RCVTIMEO."""
        if self.kind in (PUSH, PUB):
            raise ZMTPError(f"a {self.kind} socket does not receive")
        with self._cond:
            self._check_open()
            if self.kind == REQ and self._asked is None:
                raise ZMTPError("a REQ socket receives only after a request")
            deadline = self._deadline(RCVTIMEO)
            while not self._inbox:
                self._wait(flags, deadline)
            peer, envelope, frames = self._inbox.popleft()
            if self.kind == REQ:
                self._asked = None
            elif self.kind == REP:
                self._answer = (peer, envelope)
            self._cond.notify_all()
            return frames[0] if frames else b""

    def poll(self, timeout: float | None = None, flags: int = POLLIN) -> int:
        """The events among ``flags`` that are ready, waiting up to
        ``timeout`` ms for one (None or < 0: until one is)."""
        deadline = (None if timeout is None or timeout < 0
                    else time.monotonic() + timeout / 1e3)
        with self._cond:
            while True:
                ready = self._events() & flags
                if ready or self._closed:
                    return ready
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return 0
                self._cond.wait(left)

    def close(self, linger: int | None = None) -> None:
        """Stop listening and connecting, wait up to ``linger`` ms (the
        LINGER option when None) for queued messages to leave, then drop
        every connection and join every thread (each within _JOIN_S)."""
        linger = self._opts[LINGER] if linger is None else int(linger)
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._closing.set()
            deadline = None if linger < 0 else time.monotonic() + linger / 1e3
            while any(p.out for p in self._peers):
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._cond.wait(left)
            for p in self._peers:
                p.alive = False
                p.out.clear()
            self._cond.notify_all()
            raws = list(self._raws) + [ls for ls, _ in self._listeners]
        for s in raws:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(_JOIN_S)
        for _, path in self._listeners:
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # -- inside: waiting and routing (called with the condition held) -------
    def _check_open(self) -> None:
        if self._closed:
            raise ZMTPError(f"the {self.kind} socket is closed")

    def _deadline(self, option: str) -> float | None:
        ms = self._opts[option]
        return None if ms < 0 else time.monotonic() + ms / 1e3

    def _wait(self, flags: int, deadline: float | None) -> None:
        if flags & NOBLOCK:
            raise Again(f"{self.kind}: not now")
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise Again(f"{self.kind}: timed out")
        self._cond.wait(left)
        self._check_open()

    def _pick(self) -> _Peer | None:
        """The next peer in turn whose queue has room, None when there is
        none (PUSH, REQ)."""
        hwm = self._opts[SNDHWM]
        n = len(self._peers)
        for i in range(n):
            p = self._peers[(self._rr + i) % n]
            if len(p.out) < hwm:
                self._rr = (self._rr + i + 1) % n
                return p
        return None

    def _events(self) -> int:
        ready = POLLIN if self._inbox and self.kind not in (PUSH, PUB) else 0
        if self.kind in (PUB, XPUB):
            ready |= POLLOUT
        elif self.kind == REP:
            if self._answer is not None:
                ready |= POLLOUT
        elif self.kind == PUSH or (self.kind == REQ and self._asked is None):
            if any(len(p.out) < self._opts[SNDHWM] for p in self._peers):
                ready |= POLLOUT
        return ready

    # -- inside: connections ---------------------------------------------------
    def _spawn(self, target, *args, name: str) -> None:
        t = threading.Thread(target=target, args=args, daemon=True, name=name)
        with self._cond:
            self._threads = [x for x in self._threads if x.is_alive()] + [t]
        t.start()

    def _accept(self, ls: socket.socket) -> None:
        while not self._closed:
            try:
                raw, _ = ls.accept()
            except OSError:
                return
            self._spawn(self._serve, raw, name=f"zmtp-{self.kind}-peer")

    def _connector(self, address: str) -> None:
        while not self._closing.is_set():
            family, where, _ = _endpoint(address, bind=False)
            raw = socket.socket(family, socket.SOCK_STREAM)
            try:
                raw.settimeout(_HANDSHAKE_S)
                raw.connect(where)
            except OSError:
                raw.close()
                self._closing.wait(_RECONNECT_S)
                continue
            self._serve(raw)
            self._closing.wait(_RECONNECT_S)

    def _serve(self, raw: socket.socket) -> None:
        """Handshake, then read the peer until the connection ends; its
        writer runs on a thread of its own."""
        with self._cond:
            if self._closed:
                raw.close()
                return
            self._raws.add(raw)
        peer = None
        try:
            if raw.family != socket.AF_UNIX:
                raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            raw.settimeout(_HANDSHAKE_S)
            _handshake(raw, self.kind)
            raw.settimeout(None)
            peer = _Peer(raw)
            with self._cond:
                self._check_open()
                if self.kind == SUB:
                    peer.out.extend([b"\x01" + t] for t in self._topics)
                self._peers.append(peer)
                self._cond.notify_all()
            self._spawn(self._write, peer, name=f"zmtp-{self.kind}-write")
            self._read(peer)
        except (OSError, ZMTPError):
            pass  # the connection ends; a connecting socket tries again
        finally:
            with self._cond:
                self._raws.discard(raw)
                if peer is not None:
                    self._drop(peer)
            try:
                raw.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raw.close()

    def _drop(self, peer: _Peer) -> None:
        peer.alive = False
        peer.out.clear()
        if peer in self._peers:
            self._peers.remove(peer)
            for t in peer.subs:
                self._unsubscribe(t)
        self._cond.notify_all()

    def _write(self, peer: _Peer) -> None:
        try:
            while True:
                with self._cond:
                    while peer.alive and not peer.out:
                        self._cond.wait()
                    if not peer.alive:
                        return
                    frames = peer.out[0]
                for i, f in enumerate(frames):
                    head = _frame_head(_MORE if i + 1 < len(frames) else 0, len(f))
                    if len(f) <= 8192:
                        peer.raw.sendall(head + bytes(f))
                    else:
                        peer.raw.sendall(head)
                        peer.raw.sendall(f)
                with self._cond:
                    if peer.out:
                        peer.out.popleft()
                    self._cond.notify_all()
        except OSError:
            try:  # the reader sees the end and drops the peer
                peer.raw.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _read(self, peer: _Peer) -> None:
        while True:
            flags, body = _read_frame(peer.raw)
            if flags & _COMMAND:
                self._command(peer, body)
                continue
            frames = [body]
            while flags & _MORE:
                flags, body = _read_frame(peer.raw)
                frames.append(body)
            with self._cond:
                self._deliver(peer, frames)

    def _command(self, peer: _Peer, body: bytes) -> None:
        name, data = body[1:1 + body[0]], body[1 + body[0]:]
        if name == b"ERROR":
            raise ZMTPError(f"the peer sent ERROR {data[1:]!r}")
        if name in (b"SUBSCRIBE", b"CANCEL") and self.kind in (PUB, XPUB):
            with self._cond:
                self._subscription(peer, (b"\x01" if name == b"SUBSCRIBE"
                                          else b"\x00") + data)
        # PING and other commands ask nothing of a NULL-mechanism peer here

    def _deliver(self, peer: _Peer, frames: list[bytes]) -> None:
        """One message from ``peer``, with the condition held."""
        if self.kind in (PUB, XPUB):
            self._subscription(peer, frames[0])
            return
        if self.kind == PUSH:
            return
        envelope: list[bytes] = []
        if self.kind == SUB and not any(
                frames[0][:len(t)] == t for t in self._topics):
            return
        if self.kind == REQ:
            if peer is not self._asked or not frames or frames[0] != b"":
                return  # not the reply to the request outstanding
            frames = frames[1:]
        if self.kind == REP:
            if b"" not in frames:
                return  # no envelope: not a request
            cut = frames.index(b"") + 1
            envelope, frames = frames[:cut], frames[cut:]
        while (len(self._inbox) >= self._opts[RCVHWM] and peer.alive
               and not self._closed):
            self._cond.wait()
        self._inbox.append((peer, envelope, frames))
        self._cond.notify_all()

    def _subscription(self, peer: _Peer, msg: bytes) -> None:
        if not msg or msg[0] not in (0, 1):
            return
        topic = bytes(msg[1:])
        if msg[0] == 1:
            peer.subs.append(topic)
            self._subscribed[topic] += 1
            if self.kind == XPUB and self._subscribed[topic] == 1:
                self._inbox.append((None, [], [b"\x01" + topic]))
        elif topic in peer.subs:
            peer.subs.remove(topic)
            self._unsubscribe(topic)
        self._cond.notify_all()

    def _unsubscribe(self, topic: bytes) -> None:
        self._subscribed[topic] -= 1
        if self._subscribed[topic] <= 0:
            del self._subscribed[topic]
            if self.kind == XPUB:
                self._inbox.append((None, [], [b"\x00" + topic]))
