"""The FM channelizer chain as ONE kernel (reference:
newsched_tpu/ops/pallas/fm_chain.py ``fm_chain_step_planes``).

Fuses the flagship model's whole per-batch pipeline (BASELINE config #2:
M-channel PFB -> per-channel quadrature demod -> per-channel decimating
audio FIR) into a single pass over the input; the kernel is
``csrc/fm_chain.cu``, whose header says how it maps onto the H100.

Layout: the stream is planes rows, (n, 2M) f32, row k = [re | im] of input
samples x[kM-(M-1) .. kM] (the rows of the PFB commutator matrix V,
continued across batches). Per row t:

    fold:   acc[t] = sum_q c2[q] * vp[t + off + q]      vp = [halo; vb]
    DFT:    Y[t] = acc[t] @ [[Wr, Wi], [-Wi, Wr]]
    demod:  aud[t] = atan2(Im, Re)(conj(Y[t-1]) * Y[t]) * gain, Y[-1] = prev0
    audio:  out[o] = sum_k ataps[k] * aud[o*decim - k], aud[<0] from tail0

State kept in the reference's layouts: ``prev`` is the last Y row
[re | im]; ``tail`` the last A-1 aud rows, duplicated in both halves.

Precision: the TPU kernel offers accuracy tiers (``split3``, HIGHEST) that
exist because its matrix unit works in bf16 passes. Here every value of
``precision`` computes in FP32 throughout, with the degree-9 atan2
polynomial: at least as accurate as every TPU tier.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build
from newsched_tpu_torch.ops.cuda.mathfns import ATAN_COEFFS, atan2_plain

PRECISIONS = ("split3", "highest", "high", "default")
_SMEM_MAX = 232448  # bytes of shared memory one H100 block may use


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def planes_taps(c: np.ndarray) -> np.ndarray:
    """(L, M) arm-fold coefficients -> (L, 2M) for the planes layout."""
    c = np.asarray(c, np.float32)
    return np.concatenate([c, c], axis=1)


def planes_dft_matrix(M: int) -> np.ndarray:
    """(2M, 2M) real matrix computing the channelizer phase combine on the
    planes layout: [ar | ai] @ [[Wr, Wi], [-Wi, Wr]] = [yr | yi]."""
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * np.exp(-2j * np.pi * k / M)[None, :]
    Wr, Wi = W.real.astype(np.float32), W.imag.astype(np.float32)
    top = np.concatenate([Wr, Wi], axis=1)
    bot = np.concatenate([-Wi, Wr], axis=1)
    return np.concatenate([top, bot], axis=0)


def _pick_tile(n_out: int, tile: int, decim: int) -> int:
    if n_out % tile != 0:
        if n_out <= tile:
            tile = n_out
        else:
            tile = next(t for t in range(tile, 0, -1) if n_out % t == 0)
    if tile % decim != 0:
        raise ValueError(f"tile {tile} not divisible by audio decim {decim}")
    return tile


class FmChainConsts(NamedTuple):
    """The chain's constants as tensors on one device: fold taps (L, 2M),
    DFT matrix (2M, 2M) and audio taps (A,)."""

    c2: torch.Tensor
    w2: torch.Tensor
    ataps: torch.Tensor


def fm_chain_consts(arm_c: np.ndarray, ataps: np.ndarray,
                    device) -> FmChainConsts:
    """arm_c: (L, M) fold coefficients (the reference's ``fold_c``);
    ataps: (A,) audio FIR taps."""
    M = int(np.asarray(arm_c).shape[1])

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return FmChainConsts(t(planes_taps(arm_c)), t(planes_dft_matrix(M)),
                         t(np.asarray(ataps, np.float32)))


def fm_chain_step_planes_plain(vb, halo, prev0, tail0, consts: FmChainConsts,
                               decim: int, gain: float):
    """The plain PyTorch version of ``fm_chain_step_planes`` (warm=0):
    the same sums, written over whole tensors."""
    L, W = consts.c2.shape
    M = W // 2
    A = consts.ataps.shape[0]
    n, H8 = vb.shape[0], halo.shape[0]
    vp = torch.cat([halo, vb])
    off = H8 - (L - 1)
    acc = consts.c2[0] * vp[off:off + n]
    for q in range(1, L):
        acc = acc + consts.c2[q] * vp[off + q:off + q + n]
    Y = acc @ consts.w2
    P = torch.cat([prev0, Y[:-1]])
    ar, ai, yr, yi = P[:, :M], P[:, M:], Y[:, :M], Y[:, M:]
    aud = atan2_plain(ar * yi - ai * yr, ar * yr + ai * yi) * gain
    audfull = torch.cat([tail0[:, :M], aud])  # row s <-> aud[s - (A-1)]
    n_o = n // decim
    out = torch.zeros((n_o, M), dtype=torch.float32, device=vb.device)
    for k in range(A):
        s = A - 1 - k
        out = out + consts.ataps[k] * audfull[s:s + n_o * decim:decim]
    tail = aud[n - (A - 1):]
    return out, Y[n - 1:].clone(), torch.cat([tail, tail], dim=1)


def fm_chain_step_planes(vb: torch.Tensor, halo: torch.Tensor,
                         prev0: torch.Tensor, tail0: torch.Tensor,
                         consts: FmChainConsts, decim: int, gain: float,
                         warm: int = 0, tile: int = 128,
                         precision="split3"):
    """Run one batch of the fused chain on the planes-rows stream format.

    Args:
      vb: (n, 2M) f32 — this batch's planes rows.
      halo: (H8, 2M) f32 — the rows immediately PRECEDING vb in stream order
        (zeros at stream start); H8 = round8(L-1). Only its last L-1 rows
        feed the fold. Next batch's halo is vb's own last H8 rows.
      prev0/tail0: (1, 2M) / (A-1, 2M) f32 carried demod/audio state.
      consts: ``fm_chain_consts(arm_c, ataps, device)``.
      decim: audio decimation; gain: demod gain.
      warm: 0. (The reference's warm-up recompute serves the sharded
        flagship, a later slice.)
      tile: rows per CUDA block (shrunk to a divisor of n as the reference
        does; decim must divide it). Outputs do not depend on it. 128 is
        the faster of 128 and 256 at the flagship shape on an H100.
      precision: accepted for the reference's signature; FP32 always.

    Returns (audio (n//decim, M) f32, prev (1, 2M), tail (A-1, 2M)).

    CPU tensors take the plain version; CUDA tensors launch
    ``fm_chain_planes_launch`` (csrc/fm_chain.cu).
    """
    if int(warm) != 0:
        raise NotImplementedError(
            "warm > 0 (the sharded flagship's recompute) is not ported yet")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    L, W = (int(d) for d in consts.c2.shape)
    M = W // 2
    A = int(consts.ataps.shape[0])
    n = int(vb.shape[0])
    H8 = _round8(L - 1)
    tile = _pick_tile(n, tile, decim)
    if A - 1 > tile:
        raise ValueError(f"audio tail {A-1} exceeds tile {tile}")
    if tile < H8:
        raise ValueError(f"tile {tile} < H8 {H8} (batch rows must be >= {H8})")
    if int(halo.shape[0]) != H8:
        raise ValueError(f"halo rows {halo.shape[0]} != H8 = {H8}")
    if vb.device.type == "cpu":
        return fm_chain_step_planes_plain(vb, halo, prev0, tail0, consts,
                                          decim, gain)
    if W != 128:
        raise ValueError(f"planes width {W}: the CUDA kernel is built for "
                         f"M=64 channels (2M=128 lanes)")
    smem = -(-(tile + A) // 32) * 32 * W * 4
    if smem > _SMEM_MAX:
        raise ValueError(f"tile {tile}: {smem} bytes of shared memory, the "
                         f"H100 allows {_SMEM_MAX}; pass a smaller tile")
    dev = vb.device
    for name, t, shape in (("vb", vb, (n, W)), ("halo", halo, (H8, W)),
                           ("prev0", prev0, (1, W)),
                           ("tail0", tail0, (A - 1, W)),
                           ("c2", consts.c2, (L, W)),
                           ("w2", consts.w2, (W, W)),
                           ("ataps", consts.ataps, (A,))):
        _build.check_tensor(t, name, device=dev, shape=shape)
    aud = torch.empty((n // decim, M), dtype=torch.float32, device=dev)
    prev = torch.empty((1, W), dtype=torch.float32, device=dev)
    tail = torch.empty((A - 1, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_planes_launch(
            vb.data_ptr(), halo.data_ptr(), prev0.data_ptr(),
            tail0.data_ptr(), consts.c2.data_ptr(), consts.w2.data_ptr(),
            consts.ataps.data_ptr(), aud.data_ptr(), prev.data_ptr(),
            tail.data_ptr(), n, M, L, H8, A, int(decim), tile, float(gain),
            ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_planes_launch")
    fm_chain_step_planes.launches += 1
    return aud, prev, tail


fm_chain_step_planes.launches = 0
