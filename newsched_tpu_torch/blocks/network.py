"""Raw socket stream blocks (reference: newsched_tpu/blocks/network.py):
tcp_source/tcp_sink, udp_source/udp_sink.

The native ring does the byte moving:
- a source hands its connected socket's fd to a C++ pump thread that
  streams it into a double-mapped ring (io/native/vmcirc_ring.cpp);
  ``host_pull`` drains fixed-size batches for the runner's staging;
- a sink writes each batch (``host_push``) into a ring that a C++ drain
  thread writes to the socket (``max_chunk`` = one datagram for UDP), with
  ring-full backpressure.

``use_native``: True takes the ring (a failed build raises with g++'s
message), False plain Python socket I/O, None the ring where its library
builds, else Python I/O, and logs the choice. ``ring_reads`` counts the
bytes a source's ring delivered in its last run.

Streams are raw little-endian item bytes with no framing; peers agree on
the dtype out of band (GNU Radio's tcp/udp blocks' contract). A TCP peer's
close is the end of the stream (the rest of the batch zero-filled, totals
bounded by a head block); UDP is lossy by nature. A pump that brings no
data for ``timeout_s`` raises TimeoutError; ``request_abort`` (the
runner's stop) ends a waiting read with StreamAborted.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np

from newsched_tpu_torch.runtime.block import Block, StreamAborted
from newsched_tpu_torch.utils.dtypes import port_dtype

_UDP_PAYLOAD = 32768  # bytes per datagram (safe under the 64 KiB UDP cap)


def _ring(owner: Block, use_native: bool | None, ring_bytes: int):
    """The block's ring, or None for Python socket I/O (module doc)."""
    from newsched_tpu_torch import io

    if use_native is None:
        use_native = io.native_available()
        if use_native:
            owner.log.info("native ring (use_native=None)")
        else:
            owner.log.warning("Python socket I/O (use_native=None): %s",
                              io.native_ring.build_error())
    return io.VmcircRing(ring_bytes) if use_native else None


def _serve_one(host: str, port: int, timeout: float | None) -> socket.socket:
    """Bind, accept one peer (waiting at most ``timeout`` s, None: for
    ever), return its socket in blocking mode."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    srv.settimeout(timeout)
    try:
        conn, _ = srv.accept()
    finally:
        srv.close()
    conn.settimeout(None)
    return conn


class _socket_source(Block):
    host_io = True

    def __init__(self, dtype, ring_bytes, use_native, timeout_s, name):
        super().__init__(name)
        self.dtype = port_dtype(dtype)
        self.ring_bytes = ring_bytes
        self.use_native = use_native
        self.timeout_s = float(timeout_s)
        self.add_output("out", self.dtype)
        self._sock = None
        self._ring = None
        self._leftover = b""
        self._abort = threading.Event()
        self.ring_reads = 0

    def _make_socket(self) -> socket.socket:  # connected or bound
        raise NotImplementedError

    def start(self):
        self._abort.clear()
        self.ring_reads = 0
        self._sock = self._make_socket()
        self._ring = _ring(self, self.use_native, self.ring_bytes)
        if self._ring is not None:
            self._ring.start_fd_pump(self._sock.fileno(), owns_fd=False)
        else:
            self._sock.settimeout(0.1)  # so a stop is seen between recvs

    def stop(self):
        if self._ring is not None:
            self.ring_reads = self._ring.reads
            self._ring.close()
            self._ring = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def request_abort(self) -> None:
        """Cross-thread: end a waiting read with StreamAborted."""
        self._abort.set()

    def host_pull(self, nout: int) -> np.ndarray:
        out = np.empty(nout, dtype=self.dtype.np_dtype)
        if self._ring is not None:
            self._ring.read_exact(out, timeout=self.timeout_s,
                                  abort=self._abort)
            return out
        buf = out.view(np.uint8).reshape(-1)
        want, mv, got = buf.nbytes, memoryview(buf), 0
        if self._leftover:
            take = min(len(self._leftover), want)
            mv[:take] = self._leftover[:take]
            self._leftover = self._leftover[take:]
            got = take
        deadline = time.monotonic() + self.timeout_s
        while got < want:
            if self._abort.is_set():
                raise StreamAborted(f"{self.name}: receive aborted")
            try:
                chunk = self._sock.recv(min(want - got, 1 << 20))
            except socket.timeout:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{self.name}: no data for "
                                       f"{self.timeout_s} s") from None
                continue
            if not chunk:
                mv[got:] = b"\x00" * (want - got)
                break
            take = min(len(chunk), want - got)
            mv[got:got + take] = chunk[:take]
            if take < len(chunk):
                self._leftover = chunk[take:]
            got += take
            deadline = time.monotonic() + self.timeout_s
        return out

    def work(self, state, ins, params, nout):
        return state, {"out": ins["host_in"]}


class tcp_source(_socket_source):
    """Receive a raw item stream over TCP.

    mode="server" binds and accepts one peer (start() waits up to
    ``timeout_s`` for the sender); mode="client" connects out. The peer's
    close is the end of the stream."""

    def __init__(self, port: int, host: str = "127.0.0.1", mode: str = "server",
                 dtype="cf32", ring_bytes: int = 1 << 24,
                 use_native: bool | None = None, timeout_s: float = 10.0,
                 name=None):
        super().__init__(dtype, ring_bytes, use_native, timeout_s, name)
        self.port, self.host, self.mode = int(port), host, mode

    def _make_socket(self):
        if self.mode == "server":
            return _serve_one(self.host, self.port, self.timeout_s)
        s = socket.create_connection((self.host, self.port), timeout=10)
        s.settimeout(None)
        return s


class udp_source(_socket_source):
    """Receive raw item datagrams over UDP (GNU Radio's udp_source; SDR
    front ends' IQ feeds). Payloads are concatenated into the stream with
    no sequence numbers: a lost datagram is missing samples."""

    def __init__(self, port: int, host: str = "0.0.0.0", dtype="cf32",
                 ring_bytes: int = 1 << 24, use_native: bool | None = None,
                 timeout_s: float = 10.0, name=None):
        super().__init__(dtype, ring_bytes, use_native, timeout_s, name)
        self.port, self.host = int(port), host

    def _make_socket(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        s.bind((self.host, self.port))
        return s


class _socket_sink(Block):
    host_io = True
    collect_is_stream = True

    def __init__(self, dtype, vlen, ring_bytes, max_chunk, use_native, name):
        super().__init__(name)
        self.dtype = port_dtype(dtype)
        self.ring_bytes = ring_bytes
        self.max_chunk = max_chunk
        self.use_native = use_native
        self.add_input("in", self.dtype, tuple(vlen))
        self._sock = None
        self._ring = None

    def _make_socket(self) -> socket.socket:
        raise NotImplementedError

    def start(self):
        self._sock = self._make_socket()
        self._ring = _ring(self, self.use_native, self.ring_bytes)
        if self._ring is not None:
            self._ring.start_fd_drain(self._sock.fileno(), owns_fd=False,
                                      max_chunk=self.max_chunk)

    def stop(self):
        if self._ring is not None:
            self._ring.set_eof()
            try:
                self._ring.wait_drained(timeout=10)
            finally:
                self._ring.close()
                self._ring = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def host_push(self, batch: np.ndarray) -> None:
        arr = np.ascontiguousarray(batch, dtype=self.dtype.np_dtype)
        if self._ring is not None:
            self._ring.write_all(arr)
            return
        buf = arr.view(np.uint8).reshape(-1).tobytes()
        if self.max_chunk:
            for i in range(0, len(buf), self.max_chunk):
                self._sock.send(buf[i:i + self.max_chunk])
        else:
            self._sock.sendall(buf)

    def finalize(self, collected, total):
        pass  # streamed already via host_push


class tcp_sink(_socket_sink):
    """Send the stream over TCP (mode mirrors tcp_source; a client retries
    a refused connection for 5 s). ``vlen``: the items' vector length (a
    channelizer's (nchans,) audio rows), sent row after row."""

    def __init__(self, port: int, host: str = "127.0.0.1", mode: str = "client",
                 dtype="cf32", vlen=(), ring_bytes: int = 1 << 24,
                 use_native: bool | None = None, name=None):
        super().__init__(dtype, vlen, ring_bytes, 0, use_native, name)
        self.port, self.host, self.mode = int(port), host, mode

    def _make_socket(self):
        if self.mode == "server":
            return _serve_one(self.host, self.port, None)
        for i in range(50):
            try:
                s = socket.create_connection((self.host, self.port), timeout=10)
                s.settimeout(None)
                return s
            except ConnectionRefusedError:
                if i == 49:
                    raise
                time.sleep(0.1)


class udp_sink(_socket_sink):
    """Send the stream as UDP datagrams of payload_bytes each."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 payload_bytes: int = _UDP_PAYLOAD, dtype="cf32",
                 ring_bytes: int = 1 << 24, use_native: bool | None = None,
                 name=None):
        super().__init__(dtype, (), ring_bytes, int(payload_bytes), use_native,
                         name)
        self.port, self.host = int(port), host

    def _make_socket(self):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
        s.connect((self.host, self.port))  # fixes the peer so write() works
        return s
