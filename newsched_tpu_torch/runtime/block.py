"""Block, Port, and parameter machinery (reference:
newsched_tpu/runtime/block.py).

A Block is:

  - a declarative spec: typed stream ports (with per-item shape, the
    reference's vlen), a rational relative rate (out items per in item),
    parameter descriptors, message ports, a tag propagation policy;
  - a work function ``work(state, ins, params, nout) -> (state, outs)``
    over torch tensors, called once per fixed-size time batch (a
    ``tag_aware`` block's takes ``in_tags=`` and returns its out tags too).

``consume/produce`` bookkeeping is the compile-time rate algebra
(runtime/compile.py); parameters reach ``work`` as tensors on the run's
device, refreshed from the host values when one is set (in place under
the runner's graph mode, so a captured step reads the new value).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from fractions import Fraction
from typing import Any, Callable

import numpy as np
import torch

from newsched_tpu_torch.utils.dtypes import StreamDType, port_dtype
from newsched_tpu_torch.utils.logger import get_logger

IN = "input"
OUT = "output"


class StreamAborted(Exception):
    """Raised by a host-I/O block when its stream is stopped locally (a
    user's stop(), a sibling's shutdown). The runner ends the stream there
    and delivers what was collected, a clean early end; a peer's failure
    raises another error, which fails the run."""


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


def param_tensor(value, dtype, device) -> torch.Tensor:
    """One parameter value as ``work`` gets it: ``dtype``, or for
    ``dtype=None`` int64 (an integer) or float64, on ``device``."""
    if dtype is None:
        integral = isinstance(value, (int, np.integer)) or (
            isinstance(value, np.ndarray) and value.dtype.kind in "iu")
        return torch.tensor(int(value) if integral else float(value),
                            dtype=torch.int64 if integral else torch.float64,
                            device=device)
    return torch.as_tensor(np.asarray(value, dtype=dtype), device=device)


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

    Host I/O (reference: blocks/fileio.py): a block with the class
    attribute ``host_io = True`` touches the host each batch, which keeps
    the runner in its loop (no captured CUDA graph). A source defines
    ``host_pull(nout) -> numpy array`` (or a dict of arrays): the runner
    calls it on its thread before each step, stages the batch to the run's
    device and hands it to ``work`` as the pseudo input port ``host_in``. A
    sink defines ``host_push(batch)``: the runner hands it each batch's
    collected output on the host as it is produced.

    Tags (runtime/tags.py): a block with ``tag_aware = True`` gets its
    merged input tags as ``work(..., in_tags=)`` and returns (state, outs,
    out_tags); any other block's tags follow ``tag_policy``, the
    reference's tag_propagation_policy_t: "all_to_all" (every input's tags
    on every output, offsets remapped by the rate), "one_to_one" (input i
    to output i) or "dont".
    """

    relative_rate: Fraction = Fraction(1)
    tag_policy: str = "all_to_all"

    def __init__(self, name: str | None = None):
        cls = type(self).__name__
        counter = _instance_counters.setdefault(cls, itertools.count())
        self.name = name or f"{cls.lower()}_{next(counter)}"
        self.inputs: list[Port] = list(getattr(self, "inputs", []))
        self.outputs: list[Port] = list(getattr(self, "outputs", []))
        self._param_specs: dict[str, ParamSpec] = {}
        self._param_values: dict[str, Any] = {}
        self._msg_handlers: dict[str, Callable[[Any], None]] = {}
        self._msg_subscribers: dict[str, list[tuple["Block", str]]] = {}
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
        """Set a parameter. While running, takes effect on the next batch
        (the next chunk under graph mode): the runner refreshes this
        block's parameter tensors between steps, on its own thread. A FENCE
        parameter (ParamSpec.fence) additionally calls the block's
        ``on_fence_param(name, value)`` hook to rebuild derived constants;
        the runner finds the new value and captures its graph of the step
        anew (the reference retraces). While a runner is attached, this
        holds its ``param_lock``, which the runner holds while it steps,
        captures or refreshes: a change never lands inside a step, and a
        captured chunk keeps the constants it was captured with alive."""
        spec = self._param_specs[name]
        if not spec.settable:
            raise ValueError(f"parameter {name} of {self.name} is not settable")
        rt = self._runtime
        with getattr(rt, "param_lock", None) or contextlib.nullcontext():
            self._param_values[name] = value
            if spec.fence:
                hook = getattr(self, "on_fence_param", None)
                if hook is not None:
                    hook(name, value)
            if rt is not None:
                rt.invalidate_params(self)

    def get_param(self, name: str):
        return self._param_values[name]

    def param_leaves(self, device) -> dict[str, Any]:
        """Current values as tensors on ``device`` for ``work``'s params.
        A ``dtype=None`` parameter (the NCO sources' ``dphase``, the
        ``center_freq`` fence) is a host number in the reference; here it
        is a 0-dim tensor too, int64 for an integer (a uint32 ``dphase``
        fits) and float64 otherwise, so that no step takes a host value
        that a captured graph would bake in."""
        return {name: param_tensor(self._param_values[name], spec.dtype,
                                   device)
                for name, spec in self._param_specs.items()}

    # -- messages (host-side control plane) -----------------------------
    def add_msg_port_in(self, name: str, handler: Callable[[Any], None]) -> None:
        """Register an async message handler (reference: message_port +
        register handler). Handlers run on the host between batches."""
        self._msg_handlers[name] = handler

    def add_msg_port_out(self, name: str) -> None:
        self._msg_subscribers.setdefault(name, [])

    def post_msg(self, port: str, msg: Any) -> None:
        """Publish a message to subscribers of an output message port: a
        running subscriber's runner queues it for its next batch boundary;
        an idle one handles it now."""
        for blk, in_port in self._msg_subscribers.get(port, []):
            if blk._runtime is not None:
                blk._runtime.enqueue_msg(blk, in_port, msg)
            else:
                blk._msg_handlers[in_port](msg)

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
