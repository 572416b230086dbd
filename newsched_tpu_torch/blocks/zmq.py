"""ZMQ stream transport blocks (reference: newsched_tpu/blocks/zmq.py,
GNU Radio's blocklib/zmq pub_sink, sub_source, push_sink, pull_source and
the data plane of its distributed runtime, buffer_net_zmq).

Wire format, byte for byte the reference's, so a port graph and a JAX
graph feed each other: each batch is one zmq message of a 4-byte
little-endian header length, a JSON header, then the raw item bytes. The
header carries the dtype, the count and shape, an eof flag (the in-band
DONE of the reference's flowgraph monitor), an abort flag and the batch's
tags as [absolute offset, key, values, payload] lists.

Host-boundary blocks: a push/pub sink sends every batch as it is produced
(the runner's ``host_push``), its tags read from the port's TagBatch and
key registry (runtime/tags.py); a pull/sub source feeds ``host_pull`` and,
with ``tag_capacity`` > 0, puts the received tags back on the device tag
plane. PUSH/PULL blocks at the peer's high-water mark: the cross-process
form of ring backpressure. The sockets are the port's own ZMTP 3.0
(``io/zmtp.py``), which interoperates with libzmq peers; no pyzmq is
needed.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from newsched_tpu_torch.io import zmtp
from newsched_tpu_torch.runtime.block import Block, StreamAborted
from newsched_tpu_torch.utils.dtypes import port_dtype

_POLL_MS = 100  # abort-flag check interval while blocked on a socket


def _encode_batch(arr: np.ndarray, tags=None, eof: bool = False,
                  abort: bool = False) -> bytes:
    """tags: iterable of (abs_offset, key, values_seq[, payload]); payload
    must be JSON-serializable (the wire analog of pmtf's serialization).
    abort=True marks a partition-failure frame (the control-plane EXIT the
    reference's runtime_monitor mirrors across processes)."""
    ser = []
    for t in tags or []:
        payload = t[3] if len(t) > 3 else None
        ser.append([int(t[0]), str(t[1]), list(map(float, t[2])), payload])
    header = {
        "dtype": arr.dtype.str,
        "count": int(arr.shape[0]),
        "shape": list(arr.shape),
        "eof": bool(eof),
        "abort": bool(abort),
        "tags": ser,
    }
    hb = json.dumps(header).encode()
    return len(hb).to_bytes(4, "little") + hb + arr.tobytes()


def _decode_batch(msg: bytes):
    hlen = int.from_bytes(msg[:4], "little")
    header = json.loads(msg[4 : 4 + hlen].decode())
    payload = np.frombuffer(msg[4 + hlen :], dtype=np.dtype(header["dtype"]))
    payload = payload.reshape(header["shape"]) if header["shape"] else payload
    return header, payload


class _zmq_sink_base(Block):
    host_io = True
    collect_is_stream = True
    # Receive {"data", "tags"} from the compiled step when tags flow in, so
    # they can be serialized onto the wire (reference: buffer_net_zmq ships
    # items AND tags, SURVEY.md §3.1).
    collects_tags = True

    def __init__(self, address: str, sock_type: str, bind: bool, dtype, vlen, name,
                 send_timeout_s: float | None = None, sndhwm: int | None = None):
        super().__init__(name)
        self.address = address
        self.sock_type = sock_type
        self.bind = bind
        # send_timeout_s=None (default) back-pressures indefinitely while
        # staying abort-responsive — a slow-but-alive consumer (throttled,
        # audio-paced) must NOT abort the stream. Set a bound to get
        # dead-downstream detection: the send raises after this many
        # seconds with no peer progress (test_distributed.py).
        self.send_timeout_s = None if send_timeout_s is None else float(send_timeout_s)
        # sndhwm: outgoing high-water mark in MESSAGES (batches). A small
        # value bounds how much a dead/slow peer can silently absorb before
        # back-pressure (and thus the send timeout) kicks in.
        self.sndhwm = sndhwm
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen)
        self.add_input("in", self.dtype, self.vlen)
        self._sock = None
        self._items_sent = 0
        self._abort = False

    def start(self):
        self._sock = zmtp.Socket(self.sock_type)
        if self.sndhwm is not None:
            self._sock.setsockopt(zmtp.SNDHWM, int(self.sndhwm))
        if self.bind:
            self._sock.bind(self.address)
        else:
            self._sock.connect(self.address)
        self._items_sent = 0
        self._abort = False

    def _send(self, data: bytes) -> None:
        """Send with back-pressure (peer HWM) while staying responsive to a
        local abort, BOUNDED by send_timeout_s — the reverse liveness edge
        of the control plane: if the DOWNSTREAM partition dies mid-stream,
        this raises and the local runner's wait() surfaces it, instead of
        blocking on POLLOUT forever (reference: runtime_monitor mirrors
        EXIT in both directions across runtime_proxy, SURVEY.md §4.5)."""
        deadline = (None if self.send_timeout_s is None
                    else time.monotonic() + self.send_timeout_s)
        while True:
            if self._abort:
                raise StreamAborted(f"{self.name}: send aborted")
            try:
                self._sock.send(data, flags=zmtp.NOBLOCK)
                return
            except zmtp.Again:
                self._sock.poll(_POLL_MS, zmtp.POLLOUT)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self.name}: peer at {self.address} accepted no "
                        f"data within {self.send_timeout_s}s — downstream "
                        "partition dead?")

    def request_abort(self) -> None:
        """Cross-thread: unblock a pending send and end the stream cleanly."""
        self._abort = True

    def send_abort(self) -> None:
        """Ship an abort frame so downstream partitions fail within one
        batch instead of waiting out their receive timeout (reference:
        runtime_monitor mirroring EXIT across runtime_proxy, SURVEY.md §4.5)."""
        if self._sock is not None:
            try:
                self._sock.send(_encode_batch(
                    np.empty((0,) + self.vlen, self.dtype.np_dtype), abort=True),
                    flags=zmtp.NOBLOCK)
            except (zmtp.Again, zmtp.ZMTPError):
                pass

    def stop(self):
        if self._sock is not None:
            try:
                # EOF delivery is bounded, not best-effort-once: retry up
                # to eof_timeout so a live-but-backlogged peer still gets a
                # clean end-of-stream, while a dead peer can never hang
                # teardown (the old unconditionally-blocking send
                # deadlocked shutdown when the peer died mid-stream).
                eof = _encode_batch(
                    np.empty((0,) + self.vlen, self.dtype.np_dtype), eof=True)
                eof_timeout = 0.0 if self._abort else (
                    self.send_timeout_s if self.send_timeout_s is not None
                    else 5.0)
                deadline = time.monotonic() + eof_timeout
                while True:
                    try:
                        self._sock.send(eof, flags=zmtp.NOBLOCK)
                        break
                    except zmtp.Again:
                        if time.monotonic() > deadline:
                            break
                        self._sock.poll(_POLL_MS, zmtp.POLLOUT)
            except zmtp.ZMTPError:
                pass
            self._sock.close(linger=1000)
            self._sock = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def host_push(self, batch) -> None:
        """batch: array, or {"data", "tags": TagBatch} when tags flow.
        Tag offsets go absolute on the wire (sender stream position)."""
        from newsched_tpu_torch.runtime import tags as tags_mod

        wire_tags = []
        if isinstance(batch, dict) and "tags" in batch:
            tb = batch["tags"]
            batch = batch["data"]
            offs = np.asarray(tb.offsets)
            keys = np.asarray(tb.keys)
            vals = np.asarray(tb.values)
            valid = np.asarray(tb.valid)
            pids = None if tb.pids is None else np.asarray(tb.pids)
            for i in np.nonzero(valid)[0]:
                payload = (tags_mod.PAYLOADS.get(int(pids[i]))
                           if pids is not None else None)
                wire_tags.append((self._items_sent + int(offs[i]),
                                  tags_mod.REGISTRY.name(int(keys[i])),
                                  vals[i].tolist(), payload))
        arr = np.asarray(batch)
        self._send(_encode_batch(arr, tags=wire_tags))
        self._items_sent += int(arr.shape[0])

    def finalize(self, collected, total):
        pass  # streamed already via host_push


class push_sink(_zmq_sink_base):
    """PUSH socket sink (reference zmq::push_sink); pairs with pull_source."""

    def __init__(self, address: str, bind: bool = True, dtype="cf32", vlen=(),
                 send_timeout_s: float | None = None, sndhwm: int | None = None,
                 name=None):
        super().__init__(address, "PUSH", bind, dtype, vlen, name,
                         send_timeout_s, sndhwm)


class pub_sink(_zmq_sink_base):
    """PUB socket sink (reference zmq::pub_sink)."""

    def __init__(self, address: str, bind: bool = True, dtype="cf32", vlen=(),
                 send_timeout_s: float | None = None, sndhwm: int | None = None,
                 name=None):
        super().__init__(address, "PUB", bind, dtype, vlen, name,
                         send_timeout_s, sndhwm)


class _zmq_source_base(Block):
    host_io = True

    def __init__(self, address: str, sock_type: str, bind: bool, dtype, vlen, name,
                 timeout_s: float = 30.0, tag_capacity: int = 0,
                 rcvhwm: int | None = None):
        super().__init__(name)
        self.address = address
        self.sock_type = sock_type
        self.bind = bind
        self.timeout_s = timeout_s
        # rcvhwm: received messages (batches) held before the socket stops
        # reading; with the sender's sndhwm it bounds how far a producer
        # can run ahead of this source's consumer.
        self.rcvhwm = rcvhwm
        self.dtype = port_dtype(dtype)
        self.vlen = tuple(vlen)
        # tag_capacity > 0: re-emit received wire tags into the local tag
        # plane (per-batch static capacity; reference buffer_net_zmq
        # deserializes tags the same way).
        self.tag_capacity = int(tag_capacity)
        self.tag_aware = self.tag_capacity > 0
        self.add_output("out", self.dtype, self.vlen)
        self._sock = None
        self._residual: np.ndarray | None = None
        self._eof = False
        self._pos = 0  # absolute items emitted
        self._pending_tags: list = []  # (abs_offset, key, values, payload)
        self._abort = False
        # set once a batch has been received: a caller acts on the running
        # stream (a retune, a stop) by waiting on it, not on a sleep
        self.first_batch = threading.Event()

    def start(self):
        self._sock = zmtp.Socket(self.sock_type)
        if self.rcvhwm is not None:
            self._sock.setsockopt(zmtp.RCVHWM, int(self.rcvhwm))
        if self.sock_type == "SUB":
            self._sock.setsockopt(zmtp.SUBSCRIBE, b"")
        if self.bind:
            self._sock.bind(self.address)
        else:
            self._sock.connect(self.address)
        self._residual = np.empty((0,) + self.vlen, self.dtype.np_dtype)
        self._eof = False
        self._pos = 0
        self._pending_tags = []
        self._abort = False
        self.first_batch.clear()

    def request_abort(self) -> None:
        """Cross-thread: unblock a pending receive and end the stream
        cleanly (Runtime.stop / sibling-partition shutdown)."""
        self._abort = True

    def _recv(self) -> bytes:
        """Blocking receive that stays responsive to a local abort and
        enforces the receive timeout (peer liveness bound)."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            if self._abort:
                raise StreamAborted(f"{self.name}: receive aborted")
            if self._sock.poll(_POLL_MS):
                return self._sock.recv()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.name}: no data from {self.address} within "
                    f"{self.timeout_s}s — peer partition dead?")

    def stop(self):
        if self._sock is not None:
            self._sock.close(linger=0)
            self._sock = None

    def host_pull(self, nout: int):
        out = np.zeros((nout,) + self.vlen, self.dtype.np_dtype)
        got = 0
        res = self._residual
        while got < nout:
            if res.shape[0] > 0:
                take = min(nout - got, res.shape[0])
                out[got : got + take] = res[:take]
                res = res[take:]
                got += take
                continue
            if self._eof:
                break
            header, payload = _decode_batch(self._recv())
            if header.get("abort"):
                raise RuntimeError(
                    f"{self.name}: upstream partition aborted ({self.address})")
            if header["eof"]:
                self._eof = True
                continue
            for t in header.get("tags", []):
                self._pending_tags.append((int(t[0]), str(t[1]), t[2],
                                           t[3] if len(t) > 3 else None))
            res = payload.astype(self.dtype.np_dtype, copy=False)
            self.first_batch.set()
        self._residual = res
        if not self.tag_capacity:
            self._pos += nout
            return out
        return {"data": out, **self._tag_plane(nout)}

    def _tag_plane(self, nout: int) -> dict:
        """Pop pending tags landing in [pos, pos+nout) into fixed-capacity
        host arrays for the device tag plane."""
        from newsched_tpu_torch.runtime import tags as tags_mod

        K = self.tag_capacity
        offs = np.zeros((K,), np.int32)
        keys = np.zeros((K,), np.int32)
        vals = np.zeros((K, tags_mod.VALUE_DIM), np.float32)
        valid = np.zeros((K,), bool)
        pids = np.zeros((K,), np.int32)
        start, stop = self._pos, self._pos + nout
        keep, emit = [], []
        for t in self._pending_tags:
            (emit if t[0] < stop else keep).append(t)
        self._pending_tags = keep
        k = 0
        for off, key, values, payload in emit:
            if off < start:
                self.log.warning("tag %r at %d arrived late (pos %d); dropped",
                                 key, off, start)
                continue
            if k >= K:
                self.log.warning("tag capacity %d exceeded this batch; "
                                 "tag %r at %d dropped", K, key, off)
                continue
            offs[k] = off - start
            keys[k] = tags_mod.REGISTRY.intern(key)
            for j, v in enumerate(values[: tags_mod.VALUE_DIM]):
                vals[k, j] = float(v)
            if payload is not None:
                pids[k] = tags_mod.PAYLOADS.add(payload)
            valid[k] = True
            k += 1
        self._pos = stop
        return {"offsets": offs, "keys": keys, "values": vals, "valid": valid,
                "pids": pids}

    def work(self, state, ins, params, nout, in_tags=None):
        h = ins["host_in"]
        if not self.tag_capacity:
            return state, {"out": h}
        from newsched_tpu_torch.runtime.tags import TagBatch

        tb = TagBatch(offsets=h["offsets"], keys=h["keys"], values=h["values"],
                      valid=h["valid"], pids=h["pids"])
        return state, {"out": h["data"]}, tb


class pull_source(_zmq_source_base):
    """PULL socket source (reference zmq::pull_source)."""

    def __init__(self, address: str, bind: bool = False, dtype="cf32", vlen=(),
                 timeout_s: float = 30.0, tag_capacity: int = 0,
                 rcvhwm: int | None = None, name=None):
        super().__init__(address, "PULL", bind, dtype, vlen, name, timeout_s,
                         tag_capacity, rcvhwm)


class sub_source(_zmq_source_base):
    """SUB socket source (reference zmq::sub_source)."""

    def __init__(self, address: str, bind: bool = False, dtype="cf32", vlen=(),
                 timeout_s: float = 30.0, tag_capacity: int = 0, name=None):
        super().__init__(address, "SUB", bind, dtype, vlen, name, timeout_s,
                         tag_capacity)
