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
``QuadDemodState``, ``IirState`` with its ``FirState`` inside, the AGC's
``AgcState``; ``RotatorState``, whose uint32 phase becomes an int64
tensor) become the port's NamedTuples of the same name and fields, also
inside a dict (``freq_xlating_fir``'s ``rot`` and ``fir``); so do the
sharded channelizer's ``ShardedFMState`` and ``PlanesFMState`` and the
sharded FIR's ``ShardedFirState`` (parallel/ keeps the reference's
layouts, a carry block per shard), so a sharded stream too can be handed
over mid-stream; and the digital loops' ``CostasState`` (its phase in
float32 radians, not an NCO phase) and ``MMState`` (its int32 read
position as int64, the form the kernel takes). The reference
noise sources' threefry ``key`` state has no counterpart (its bits are
jax's key chaining) and raises.

On a process mesh (``parallel.make_process_mesh``) a rank takes what the
reference's process holds: ``process_state_from_jax`` keeps the rank's
own blocks of a sharded carry (``PlanesFMState``'s and
``ShardedFirState``'s), from the addressable shards of a global
``jax.Array`` or from a whole host array, and the replicated fields
whole.

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

from newsched_tpu_torch.ops.agc import AgcState
from newsched_tpu_torch.ops.analog import QuadDemodState, RotatorState
from newsched_tpu_torch.ops.cuda import noise
from newsched_tpu_torch.ops.fir import FirState
from newsched_tpu_torch.ops.iir import IirState
from newsched_tpu_torch.ops.loops import CostasState, MMState
from newsched_tpu_torch.ops.nco import phase_tensor
from newsched_tpu_torch.ops.pfb import PfbState
from newsched_tpu_torch.parallel.channelizer import PlanesFMState, ShardedFMState
from newsched_tpu_torch.parallel.sharded_fir import ShardedFirState
from newsched_tpu_torch.runtime.block import param_tensor

# the parameters the port declares dtype=None (host numbers in the reference)
_HOST_PARAMS = ("dphase", "center_freq")
_NAMED = {cls.__name__: cls
          for cls in (PfbState, FirState, QuadDemodState, RotatorState,
                      PlanesFMState, ShardedFMState, IirState, AgcState,
                      ShardedFirState, CostasState, MMState)}


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
        out = cls(*(state_from_jax(v, device) if hasattr(v, "_fields")
                    else _tensor(v, device) for v in state))
        if cls is MMState:  # the kernel's read position is int64
            out = out._replace(pos=out.pos.to(torch.int64))
        return out
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


# the fields a process mesh shards along their first axis, by state type:
# time blocks (carries) and, for the complex-sample step, channels
_PROCESS_SHARDED = {"PlanesFMState": ("carry",), "ShardedFirState": ("carry",),
                    "ShardedFMState": ("pfb_carry", "demod_prev",
                                       "audio_tail")}


def _process_rows(v, mesh, sharded: bool) -> np.ndarray:
    """A leaf as this rank holds it: rows [r n, (r+1) n), n = len / world,
    of a sharded field, else the whole value. A global ``jax.Array`` gives
    them from its addressable shards, which is all a process of the
    reference's mesh may read."""
    if hasattr(v, "addressable_shards"):
        shards = sorted(v.addressable_shards,
                        key=lambda sh: sh.index[0].start or 0 if sh.index else 0)
        if not sharded:
            return np.asarray(shards[0].data)
        v_rows = int(v.shape[0])
    else:
        v = np.asarray(v)
        if not sharded:
            return v
        v_rows = v.shape[0]
    if v_rows % mesh.world:
        raise ValueError(f"{v_rows} rows do not split over {mesh.world} ranks")
    n = v_rows // mesh.world
    lo = mesh.rank * n
    if isinstance(v, np.ndarray):
        return v[lo:lo + n]
    parts = {sh.index[0].start or 0: np.asarray(sh.data) for sh in shards
             if lo <= (sh.index[0].start or 0) < lo + n}
    out = np.concatenate([parts[k] for k in sorted(parts)])
    if out.shape[0] != n:
        raise ValueError(f"rank {mesh.rank} addresses {out.shape[0]} of its "
                         f"{n} rows")
    return out


def process_state_from_jax(state: Any, mesh, device=None) -> Any:
    """A reference sharded state (``PlanesFMState``, ``ShardedFirState``
    or ``ShardedFMState``: global ``jax.Array`` leaves, or host arrays of
    the global state) -> this rank's port state on ``device`` (the mesh's
    by default): its own shards' carry blocks, its own channels'
    ``demod_prev`` and ``audio_tail`` rows, and the replicated fields. A
    block's state dict (the sharded hooks' of ``wbfm_rcv_fused``,
    ``wbfm_live_source``, ``fir_tone_source``) is replicated: every rank
    holds all of it."""
    if isinstance(state, dict):
        return state_from_jax({k: _process_rows(v, mesh, False)
                               for k, v in state.items()},
                              mesh.device if device is None else device)
    name = type(state).__name__
    if name not in _PROCESS_SHARDED:
        raise NotImplementedError(
            f"state of type {name} has no process-mesh form")
    local = type(state)(*(_process_rows(getattr(state, f), mesh,
                                        f in _PROCESS_SHARDED[name])
                          for f in state._fields))
    return state_from_jax(local, mesh.device if device is None else device)


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
