"""Block, Port, and parameter machinery (reference:
newsched_tpu/runtime/block.py).

A Block is:

  - a declarative spec: typed stream ports (with per-item shape, the
    reference's vlen), a rational relative rate (out items per in item),
    parameter descriptors;
  - a work function ``work(state, ins, params, nout) -> (state, outs)``
    over torch tensors, called once per fixed-size time batch.

``consume/produce`` bookkeeping is the compile-time rate algebra
(runtime/compile.py); parameters reach ``work`` as tensors on the run's
device, rebuilt from the host values when one is set.
"""

from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from newsched_tpu_torch.utils.dtypes import StreamDType, port_dtype
from newsched_tpu_torch.utils.logger import get_logger

IN = "input"
OUT = "output"


@dataclasses.dataclass(frozen=True)
class Port:
    """A typed stream port. item_shape is the reference's vlen generalized:
    each stream item may itself be an array (e.g. (nchans,) for the
    channelizer output)."""

    name: str
    dtype: StreamDType
    direction: str = IN
    item_shape: tuple[int, ...] = ()

    def compatible_with(self, other: "Port") -> bool:
        return self.dtype.np_dtype == other.dtype.np_dtype and self.item_shape == other.item_shape


@dataclasses.dataclass
class ParamSpec:
    name: str
    default: Any
    dtype: Any = np.float32
    settable: bool = True
    doc: str = ""
    # fence=True marks a RECOMPILE-FENCE parameter: its value is baked into
    # constants the block derives at construction (e.g. the fused wbfm
    # chain's rotated taps), so setting it calls the block's
    # ``on_fence_param`` hook to rebuild them.
    fence: bool = False


def param(default, dtype=np.float32, settable=True, doc="") -> ParamSpec:
    """Declare a runtime-settable block parameter (reference: the YAML
    ``parameters:`` stanza + request_parameter_change machinery)."""
    return ParamSpec(name="", default=default, dtype=dtype, settable=settable, doc=doc)


class _PortRef:
    """(block, port_name) endpoint used by graph.connect."""

    __slots__ = ("block", "port")

    def __init__(self, block: "Block", port: str):
        self.block = block
        self.port = port

    def __repr__(self):
        return f"{self.block.name}.{self.port}"


_instance_counters: dict[str, itertools.count] = {}


class Block:
    """Base class for all blocks.

    Subclasses set, in __init__ (or as class attrs):
      self.inputs / self.outputs: list[Port]
      self.relative_rate: Fraction — out items per in item (sync blocks: 1)
      parameters via self.declare_param(...)
    and implement:
      init_state(self, nin, nout, device) -> state (default: empty tuple)
      work(self, state, ins, params, nout) -> (new_state, outs)

    ``ins``/``outs`` map port name -> tensor of shape (n_items, *item_shape)
    on the run's device. ``params`` maps param name -> tensor on that
    device. ``nin``/``nout`` are python ints fixed by the compiler's rate
    algebra.
    """

    relative_rate: Fraction = Fraction(1)

    def __init__(self, name: str | None = None):
        cls = type(self).__name__
        counter = _instance_counters.setdefault(cls, itertools.count())
        self.name = name or f"{cls.lower()}_{next(counter)}"
        self.inputs: list[Port] = list(getattr(self, "inputs", []))
        self.outputs: list[Port] = list(getattr(self, "outputs", []))
        self._param_specs: dict[str, ParamSpec] = {}
        self._param_values: dict[str, Any] = {}
        self._runtime = None  # set by the runner while the graph is running
        self.log = get_logger(self.name)

    # -- ports ----------------------------------------------------------
    def add_input(self, name: str, dtype, item_shape: tuple[int, ...] = ()) -> Port:
        p = Port(name, port_dtype(dtype), IN, tuple(item_shape))
        self.inputs.append(p)
        return p

    def add_output(self, name: str, dtype, item_shape: tuple[int, ...] = ()) -> Port:
        p = Port(name, port_dtype(dtype), OUT, tuple(item_shape))
        self.outputs.append(p)
        return p

    def input_port(self, key: str | int) -> Port:
        return self._find(self.inputs, key)

    def output_port(self, key: str | int) -> Port:
        return self._find(self.outputs, key)

    @staticmethod
    def _find(ports: list[Port], key) -> Port:
        if isinstance(key, int):
            return ports[key]
        for p in ports:
            if p.name == key:
                return p
        raise KeyError(f"no port {key!r}; have {[p.name for p in ports]}")

    def o(self, port: str | int = 0) -> _PortRef:
        """Output endpoint for graph.connect (pythonic sugar)."""
        return _PortRef(self, self.output_port(port).name)

    def i(self, port: str | int = 0) -> _PortRef:
        return _PortRef(self, self.input_port(port).name)

    # -- parameters -----------------------------------------------------
    def declare_param(self, name: str, default, dtype=np.float32, settable=True,
                      doc="", fence=False) -> None:
        self._param_specs[name] = ParamSpec(name, default, dtype, settable,
                                            doc, fence)
        self._param_values[name] = default

    def set_param(self, name: str, value) -> None:
        """Set a parameter. While running, takes effect on the next batch:
        the runner rebuilds this block's parameter tensors. A FENCE
        parameter (ParamSpec.fence) additionally calls the block's
        ``on_fence_param(name, value)`` hook to rebuild derived constants."""
        spec = self._param_specs[name]
        if not spec.settable:
            raise ValueError(f"parameter {name} of {self.name} is not settable")
        self._param_values[name] = value
        if spec.fence:
            hook = getattr(self, "on_fence_param", None)
            if hook is not None:
                hook(name, value)
        if self._runtime is not None:
            self._runtime.invalidate_params(self)

    def get_param(self, name: str):
        return self._param_values[name]

    def param_leaves(self, device) -> dict[str, Any]:
        """Current values as tensors on ``device`` for ``work``'s params."""
        out = {}
        for name, spec in self._param_specs.items():
            v = self._param_values[name]
            if spec.dtype is None:
                out[name] = v
            else:
                out[name] = torch.as_tensor(np.asarray(v, dtype=spec.dtype),
                                            device=device)
        return out

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        """Host-side start hook (open files, sockets...). Reference:
        block::start()."""

    def stop(self) -> None:
        """Host-side stop hook. Reference: block::stop()."""

    # -- the work interface --------------------------------------------
    def init_state(self, nin: int, nout: int, device):
        return ()

    def work(self, state, ins: dict[str, torch.Tensor], params: dict[str, Any], nout: int):
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class SyncBlock(Block):
    """1:1 rate convenience base (reference: sync_block.h)."""

    relative_rate = Fraction(1)
