"""Port/stream dtype registry.

The analog of the reference's parameter-type registry
(runtime/include/gnuradio/parameter_types.h): a small table mapping the
framework's stream type names (the reference's ``cf32``/``rf32``/``ri16``…
spellings) to numpy/torch dtypes, with item sizes for host IO and type
checking at ``graph.connect`` time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_TORCH = {
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.int64): torch.int64,
}


@dataclasses.dataclass(frozen=True)
class StreamDType:
    """A stream item scalar type."""

    name: str
    np_dtype: np.dtype

    @property
    def itemsize(self) -> int:
        return self.np_dtype.itemsize

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH[self.np_dtype]

    def __repr__(self) -> str:
        return f"StreamDType({self.name})"


cf32 = StreamDType("cf32", np.dtype(np.complex64))
rf32 = StreamDType("rf32", np.dtype(np.float32))
ri32 = StreamDType("ri32", np.dtype(np.int32))
ri16 = StreamDType("ri16", np.dtype(np.int16))
ru8 = StreamDType("ru8", np.dtype(np.uint8))

_REGISTRY = {t.name: t for t in (cf32, rf32, ri32, ri16, ru8)}


def port_dtype(spec) -> StreamDType:
    """Coerce a user-facing dtype spec to a StreamDType.

    Accepts a StreamDType, a registry name ("cf32"), or a numpy dtype.
    """
    if isinstance(spec, StreamDType):
        return spec
    if isinstance(spec, str):
        if spec in _REGISTRY:
            return _REGISTRY[spec]
        spec = np.dtype(spec)
    npd = np.dtype(spec)
    for t in _REGISTRY.values():
        if t.np_dtype == npd:
            return t
    t = StreamDType(npd.name, npd)
    return t
