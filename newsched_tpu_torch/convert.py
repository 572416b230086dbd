"""Carry states and parameters over from the JAX package.

``newsched_tpu``'s ``CompiledFlowgraph.init_states()`` / ``init_params()``
(or the states after one of its steps) are per-block dicts of arrays.
These functions turn them, as numpy arrays, into the port's per-block
values on a given device, so a stream can be handed from the reference to
the port at a batch boundary.

The fused block's ``carry``/``prev``/``atail``, ``cplx_to_planes``'
``skew`` and ``vector_source``'s ``data`` map one to one onto tensors;
stream positions (``vector_source``'s ``pos``, the noise source's 64-bit
group counter ``ghi``/``glo``) become the host ints the port keeps. The
reference noise source's threefry ``key`` state has no counterpart (its
bits are jax's key chaining) and raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_HOST_INTS = ("pos", "ghi", "glo")


def state_from_jax(state: Any, device) -> Any:
    """One block's JAX state -> the port's state on ``device``."""
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
        a = np.array(v)  # a writable copy: jax hands out read-only views
        out[k] = int(a) if k in _HOST_INTS else torch.as_tensor(a, device=device)
    return out


def states_from_jax(states: dict, device) -> dict:
    """Per-block JAX states -> the port's, under the same block names."""
    return {k: state_from_jax(v, device) for k, v in states.items()}


def params_from_jax(params: dict, device) -> dict:
    """Per-block JAX parameter leaves -> tensors on ``device``."""
    return {b: {k: torch.as_tensor(np.array(v), device=device)
                for k, v in p.items()}
            for b, p in params.items()}
