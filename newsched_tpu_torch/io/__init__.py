"""Host I/O: the native double-mapped ring and its Python binding
(reference: newsched_tpu/io). The file and socket blocks fill and drain it;
the runner stages each batch in pinned host memory (runtime/runner.py)."""

from newsched_tpu_torch.io.native_ring import (  # noqa: F401
    NativeBuildError, VmcircRing, native_available)
