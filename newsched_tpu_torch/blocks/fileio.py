"""File I/O blocks (reference: newsched_tpu/blocks/fileio.py): file_source,
file_sink.

Host-boundary blocks: file_source's batches come from the host and are
staged to the run's device by the runner (``host_pull`` -> the pseudo
input ``host_in``); file_sink collects the stream and writes it at the end.
Either keeps the runner in its loop (``host_io``), where the host reads
batch i+1 while the card computes batch i.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype


class file_source(Block):
    """Stream items from a raw binary file (reference fileio::file_source).

    use_native=True: a C++ pump thread streams the file into the
    double-mapped ring (io/native/vmcirc_ring.cpp) and ``host_pull`` drains
    it, so file reads overlap the card's work; the ring's library is built
    at first use, and a failed build raises with g++'s message.
    use_native=False: numpy memmap reads on the runner's thread.
    use_native=None: the ring where its library builds, else the memmap
    reads; the choice is logged. Past the end of the file a batch is
    zero-padded; the compiler's totals (``finite_items``) trim the pad.
    ``ring_reads`` counts the bytes the ring delivered in the last run.
    """

    host_io = True

    def __init__(self, path: str, dtype="cf32", repeat: bool = False,
                 use_native: bool | None = None, ring_bytes: int = 1 << 24,
                 name=None):
        super().__init__(name)
        self.path = path
        self.repeat = repeat
        self.dtype = port_dtype(dtype)
        self.ring_bytes = ring_bytes
        self.use_native = use_native
        self.add_output("out", self.dtype)
        self._mm: np.ndarray | None = None
        self._ring = None
        self._pos = 0
        self.ring_reads = 0

    def start(self):
        from newsched_tpu_torch import io

        use_native = self.use_native
        if use_native is None:
            use_native = io.native_available()
            if use_native:
                self.log.info("%s: native ring (use_native=None)", self.path)
            else:
                self.log.warning("%s: memmap reads (use_native=None): %s",
                                 self.path, io.native_ring.build_error())
        self.ring_reads = 0
        if use_native:
            self._ring = io.VmcircRing(self.ring_bytes)
            self._ring.start_file_pump(self.path, loop=self.repeat)
        else:
            self._mm = np.memmap(self.path, dtype=self.dtype.np_dtype, mode="r")
        self._pos = 0

    def stop(self):
        if self._ring is not None:
            self.ring_reads = self._ring.reads
            self._ring.close()
            self._ring = None
        self._mm = None

    def finite_items(self, in_bound) -> int | None:
        if self.repeat:
            return None
        n = np.memmap(self.path, dtype=self.dtype.np_dtype, mode="r").shape[0]
        return int(n)

    def host_pull(self, nout: int) -> np.ndarray:
        """One batch of ``nout`` items (the runner's thread)."""
        out = np.empty(nout, dtype=self.dtype.np_dtype)
        if self._ring is not None:
            self._ring.read_exact(out)
            return out
        if self._mm is None:
            raise RuntimeError(f"{self.name}: file_source not started")
        n = len(self._mm)
        got = 0
        while got < nout:
            take = min(nout - got, n - self._pos)
            if take <= 0:
                if not self.repeat:
                    out[got:] = 0  # zero-pad past EOF; totals already bounded
                    break
                self._pos = 0
                continue
            out[got:got + take] = self._mm[self._pos:self._pos + take]
            self._pos += take
            got += take
        return out

    def work(self, state, ins, params, nout):
        # the batch the runner staged on the device
        return state, {"out": ins["host_in"]}


class file_sink(Block):
    """Write the stream to a raw binary file (reference fileio::file_sink):
    the stream is collected as a vector_sink's is and written once, at the
    end of the run, trimmed to the compiler's totals."""

    host_io = True

    def __init__(self, path: str, dtype="cf32", vlen=(), name=None):
        super().__init__(name)
        self.path = path
        self.dtype = port_dtype(dtype)
        self.add_input("in", self.dtype, tuple(vlen))
        self._fh = None

    def start(self):
        self._fh = open(self.path, "wb")

    def stop(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def work(self, state, ins, params, nout):
        return state, ins["in"]

    def finalize(self, collected, total):
        arr = np.ascontiguousarray(collected, dtype=self.dtype.np_dtype)
        if self._fh is None:
            with open(self.path, "wb") as fh:
                arr.tofile(fh)
        else:
            arr.tofile(self._fh)
