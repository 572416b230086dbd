"""Carry states and parameters over from the JAX package.

``newsched_tpu``'s ``CompiledFlowgraph.init_states()`` / ``init_params()``
(or the states after one of its steps) are per-block dicts of arrays.
These functions turn them, as numpy arrays, into the port's per-block
values on a given device, so a stream can be handed from the reference to
the port at a batch boundary.

Dict states map key by key: the fused blocks' ``carry``/``prev``/
``atail`` (the wideband-FM ones: ``carry``), the live sources'
``carry``/``prev``/``atail``, ``cplx_to_planes``' ``skew``,
``vector_quad_demod``'s ``prev`` and ``vector_source``'s ``data`` become
tensors. The stream positions become the on-card forms the port's blocks
keep, the forms their ``init_state`` gives: ``vector_source``'s ``pos``
and the NCO sources' uint32 ``phase`` (the live FIR and wideband-FM
sources' included) 0-dim int64 tensors, the noise sources' 64-bit group
counter, the reference's int32 pair ``ghi``/``glo``, ONE int64 tensor
``group`` (``noise.group64``), and the live sources' ``first`` flag a bool
tensor. NamedTuple states (``PfbState``, ``FirState``,
``QuadDemodState``; ``RotatorState``, whose uint32 phase becomes an int64
tensor) become the port's NamedTuples of the same name and fields, also
inside a dict (``freq_xlating_fir``'s ``rot`` and ``fir``); so do the
sharded channelizer's ``ShardedFMState`` and ``PlanesFMState``
(parallel/channelizer.py keeps the reference's layouts, a carry block per
shard), so a sharded stream too can be handed over mid-stream. The reference
noise sources' threefry ``key`` state has no counterpart (its bits are
jax's key chaining) and raises.

Parameters map the same way: every leaf becomes a tensor of its own
dtype, and the reference's host-number parameters (``dphase`` as uint32,
``center_freq`` as float64; ``dtype=None`` in the port) become the
int64/float64 0-dim tensors ``Block.param_leaves`` gives, in value and in
dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from newsched_tpu_torch.ops.analog import QuadDemodState, RotatorState
from newsched_tpu_torch.ops.cuda import noise
from newsched_tpu_torch.ops.fir import FirState
from newsched_tpu_torch.ops.nco import phase_tensor
from newsched_tpu_torch.ops.pfb import PfbState
from newsched_tpu_torch.parallel.channelizer import PlanesFMState, ShardedFMState
from newsched_tpu_torch.runtime.block import param_tensor

# the parameters the port declares dtype=None (host numbers in the reference)
_HOST_PARAMS = ("dphase", "center_freq")
_NAMED = {cls.__name__: cls
          for cls in (PfbState, FirState, QuadDemodState, RotatorState,
                      PlanesFMState, ShardedFMState)}


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v), device=device)  # a writable copy


def state_from_jax(state: Any, device) -> Any:
    """One block's JAX state -> the port's state on ``device``."""
    if hasattr(state, "_fields"):  # a NamedTuple state
        cls = _NAMED.get(type(state).__name__)
        if cls is None or tuple(state._fields) != cls._fields:
            raise NotImplementedError(
                f"state of type {type(state).__name__} has no port yet")
        if cls is RotatorState:
            return RotatorState(phase=phase_tensor(int(np.array(state.phase)),
                                                   device))
        return cls(*(_tensor(v, device) for v in state))
    if not isinstance(state, dict):
        if len(state):
            raise NotImplementedError(
                f"state of type {type(state).__name__} has no port yet")
        return ()
    out = {}
    for k, v in state.items():
        if k == "key":
            raise NotImplementedError(
                "a threefry key state (noise source method='threefry') has "
                "no counterpart in the port's position-pure stream")
        if hasattr(v, "_fields"):
            out[k] = state_from_jax(v, device)
        elif k == "first":
            out[k] = torch.tensor(bool(np.array(v)), device=device)
        elif k == "phase":
            out[k] = phase_tensor(int(np.array(v)), device)
        elif k == "pos":
            out[k] = torch.tensor(int(np.array(v)), dtype=torch.int64,
                                  device=device)
        elif k == "ghi":
            out["group"] = noise.group_tensor(
                noise.group64(int(np.array(v)), int(np.array(state["glo"]))),
                device)
        elif k != "glo":
            out[k] = _tensor(v, device)
    return out


def states_from_jax(states: dict, device) -> dict:
    """Per-block JAX states -> the port's, under the same block names."""
    return {k: state_from_jax(v, device) for k, v in states.items()}


def params_from_jax(params: dict, device) -> dict:
    """Per-block JAX parameter leaves -> tensors on ``device``: each of its
    own dtype, and ``dphase``/``center_freq`` in the port's on-card form
    (``Block.param_leaves``: int64 or float64, 0-dim)."""
    return {b: {k: (param_tensor(np.array(v), None, device)
                    if k in _HOST_PARAMS else _tensor(v, device))
                for k, v in p.items()}
            for b, p in params.items()}
