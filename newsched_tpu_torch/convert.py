"""Carry states and parameters over from the JAX package.

``newsched_tpu``'s ``CompiledFlowgraph.init_states()`` / ``init_params()``
(or the states after one of its steps) are per-block dicts of arrays.
These functions turn them, as numpy arrays, into the port's per-block
values on a given device, so a stream can be handed from the reference to
the port at a batch boundary.

Dict states map key by key: the fused block's ``carry``/``prev``/
``atail``, the live source's ``carry``/``prev``/``atail``,
``cplx_to_planes``' ``skew``, ``vector_quad_demod``'s ``prev`` and
``vector_source``'s ``data`` become tensors; stream positions
(``vector_source``'s ``pos``, the noise sources' 64-bit group counter
``ghi``/``glo``) become the host ints the port keeps. The staged blocks'
NamedTuple states (``PfbState``, ``FirState``) become the port's
NamedTuples of the same name and fields. The reference noise sources'
threefry ``key`` state has no counterpart (its bits are jax's key
chaining) and raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from newsched_tpu_torch.ops.fir import FirState
from newsched_tpu_torch.ops.pfb import PfbState

_HOST_INTS = ("pos", "ghi", "glo")
_NAMED = {cls.__name__: cls for cls in (PfbState, FirState)}


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v), device=device)  # a writable copy


def state_from_jax(state: Any, device) -> Any:
    """One block's JAX state -> the port's state on ``device``."""
    if hasattr(state, "_fields"):  # a NamedTuple state
        cls = _NAMED.get(type(state).__name__)
        if cls is None or tuple(state._fields) != cls._fields:
            raise NotImplementedError(
                f"state of type {type(state).__name__} has no port yet")
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
        out[k] = int(np.array(v)) if k in _HOST_INTS else _tensor(v, device)
    return out


def states_from_jax(states: dict, device) -> dict:
    """Per-block JAX states -> the port's, under the same block names."""
    return {k: state_from_jax(v, device) for k, v in states.items()}


def params_from_jax(params: dict, device) -> dict:
    """Per-block JAX parameter leaves -> tensors on ``device``."""
    return {b: {k: _tensor(v, device) for k, v in p.items()}
            for b, p in params.items()}
