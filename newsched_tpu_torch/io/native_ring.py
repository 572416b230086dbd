"""ctypes binding for the native double-mapped ring (io/native/vmcirc_ring.cpp;
reference: newsched_tpu/io/native_ring.py).

The shared library is built at first use with the system g++ (a plain C
interface, no pybind11) into ``build/ring/`` at the repository root, under a
name that carries a hash of the source and the flags, so an edited source is
never served by a stale build (as ``ops/cuda/_build.py`` builds the kernels).
Nothing is built at import. ``native_available()`` says whether the library
built; ``VmcircRing`` raises with g++'s message when it did not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from newsched_tpu_torch.runtime.block import StreamAborted

SRC = Path(__file__).resolve().parent / "native" / "vmcirc_ring.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ring"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


class NativeBuildError(RuntimeError):
    """g++ is missing, or it refused the ring's source."""


def _build() -> Path:
    """The library's path, compiled first if no build of this source and
    these flags is on disk. Raises NativeBuildError with g++'s message."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    so = BUILD_DIR / f"libvmcirc_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
    os.replace(tmp, so)  # whole or absent, for processes building at once
    return so


def _declare(lib) -> None:
    P, S = ctypes.c_void_p, ctypes.c_size_t
    U8 = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "ring_create": ([S], P), "ring_destroy": ([P], None),
        "ring_capacity": ([P], S), "ring_read_avail": ([P], S),
        "ring_write_avail": ([P], S),
        "ring_read": ([P, U8, S], S), "ring_write": ([P, U8, S], S),
        "ring_start_file_pump": ([P, ctypes.c_char_p, ctypes.c_int],
                                 ctypes.c_int),
        "ring_start_fd_pump": ([P, ctypes.c_int, ctypes.c_int], ctypes.c_int),
        "ring_pump_eof": ([P], ctypes.c_int), "ring_stop_pump": ([P], None),
        "ring_set_eof": ([P], None),
        "ring_start_fd_drain": ([P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, S], ctypes.c_int),
        "ring_start_file_drain": ([P, ctypes.c_char_p, ctypes.c_double],
                                  ctypes.c_int),
        "ring_drain_done": ([P], ctypes.c_int),
        "ring_drain_bytes": ([P], ctypes.c_uint64),
        "ring_stop_drain": ([P], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res


def _load():
    """The loaded library; raises NativeBuildError (the same one on every
    call after a failed build)."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                _declare(lib)
                _lib = lib
            except (NativeBuildError, OSError) as e:
                _build_error = str(e)
        if _lib is None:
            raise NativeBuildError(f"native ring unavailable: {_build_error}")
        return _lib


def native_available() -> bool:
    """Whether the ring's library builds and loads here (it is built now if
    it was not)."""
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def build_error() -> str | None:
    """g++'s message if the build failed, else None."""
    return _build_error


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class VmcircRing:
    """Python handle on the native double-mapped SPSC ring of at least
    ``min_size`` bytes. ``reads`` counts the bytes handed out by
    ``read_exact`` (what a caller asserts to show the ring carried a
    stream)."""

    def __init__(self, min_size: int):
        self._lib = _load()
        self._h = self._lib.ring_create(min_size)
        if not self._h:
            raise RuntimeError("ring_create failed")
        self.capacity = self._lib.ring_capacity(self._h)
        self.reads = 0

    def close(self) -> None:
        """Stop the pump and drain threads and unmap the ring."""
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ring_destroy(h)

    def __del__(self):
        self.close()

    # -- producer --------------------------------------------------------
    def write(self, data: np.ndarray) -> int:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return self._lib.ring_write(self._h, _ptr(buf), buf.nbytes)

    def write_all(self, data: np.ndarray, timeout: float = 10.0) -> None:
        """Block until every byte is in the ring (backpressure against a
        slow drain); raises TimeoutError after ``timeout`` s with no room."""
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        want, done = buf.nbytes, 0
        deadline = time.monotonic() + timeout
        while done < want:
            done += self._lib.ring_write(self._h, _ptr(buf[done:]), want - done)
            if done >= want:
                return
            if time.monotonic() > deadline:
                raise TimeoutError("ring write timed out (consumer stalled)")
            time.sleep(0.0005)

    def start_file_pump(self, path: str, loop: bool = False) -> None:
        rc = self._lib.ring_start_file_pump(self._h, os.fsencode(path),
                                            int(loop))
        if rc != 0:
            raise OSError(f"ring_start_file_pump({path}) -> {rc}")

    def start_fd_pump(self, fd: int, owns_fd: bool = False) -> None:
        """Pump an open fd (socket, pipe, device) into the ring on a native
        thread. Python keeps the fd unless owns_fd."""
        rc = self._lib.ring_start_fd_pump(self._h, fd, int(owns_fd))
        if rc != 0:
            raise OSError(f"ring_start_fd_pump(fd={fd}) -> {rc}")

    def set_eof(self) -> None:
        """The producer's end of stream (lets a drain thread finish)."""
        self._lib.ring_set_eof(self._h)

    def stop_pump(self) -> None:
        self._lib.ring_stop_pump(self._h)

    # -- drain (ring -> fd) ----------------------------------------------
    def start_file_drain(self, path: str, rate_bps: float = 0.0) -> None:
        """A native thread drains the ring into a file, paced to rate_bps
        bytes/s if nonzero."""
        rc = self._lib.ring_start_file_drain(self._h, os.fsencode(path),
                                             float(rate_bps))
        if rc != 0:
            raise OSError(f"ring_start_file_drain({path}) -> {rc}")

    def start_fd_drain(self, fd: int, owns_fd: bool = False,
                       rate_bps: float = 0.0, max_chunk: int = 0) -> None:
        """max_chunk bounds the bytes a write() (one UDP datagram)."""
        rc = self._lib.ring_start_fd_drain(self._h, fd, int(owns_fd),
                                           float(rate_bps), int(max_chunk))
        if rc != 0:
            raise OSError(f"ring_start_fd_drain(fd={fd}) -> {rc}")

    @property
    def drain_done(self) -> bool:
        return bool(self._lib.ring_drain_done(self._h))

    @property
    def drain_bytes(self) -> int:
        return int(self._lib.ring_drain_bytes(self._h))

    def stop_drain(self) -> None:
        self._lib.ring_stop_drain(self._h)

    def wait_drained(self, timeout: float = 10.0) -> None:
        """Block until the drain thread wrote everything (after set_eof)."""
        deadline = time.monotonic() + timeout
        while not self.drain_done:
            if time.monotonic() > deadline:
                raise TimeoutError("ring drain timed out")
            time.sleep(0.0005)

    @property
    def pump_eof(self) -> bool:
        return bool(self._lib.ring_pump_eof(self._h))

    # -- consumer --------------------------------------------------------
    def read_avail(self) -> int:
        return self._lib.ring_read_avail(self._h)

    def read_into(self, out: np.ndarray) -> int:
        """Copy up to out.nbytes bytes; returns the bytes copied."""
        buf = out.view(np.uint8).reshape(-1)
        return self._lib.ring_read(self._h, _ptr(buf), buf.nbytes)

    def read_exact(self, out: np.ndarray, timeout: float = 10.0,
                   abort: threading.Event | None = None) -> bool:
        """Fill ``out`` from the ring, waiting for the pump. At the pump's
        end of stream the rest is zero-filled and False returned. A pump
        that brings nothing for ``timeout`` s raises TimeoutError; ``abort``
        set raises StreamAborted (a local stop)."""
        buf = out.view(np.uint8).reshape(-1)
        want, got = buf.nbytes, 0
        deadline = time.monotonic() + timeout
        while got < want:
            n = self._lib.ring_read(self._h, _ptr(buf[got:]), want - got)
            got += n
            self.reads += n
            if got >= want:
                return True
            if n:
                deadline = time.monotonic() + timeout
            elif self.pump_eof and self.read_avail() == 0:
                buf[got:] = 0
                return False
            elif abort is not None and abort.is_set():
                raise StreamAborted("ring read aborted")
            elif time.monotonic() > deadline:
                raise TimeoutError(f"ring read timed out: no data for "
                                   f"{timeout} s (pump starved or peer dead)")
            else:
                time.sleep(0.0005)
        return True
