"""Streaming FIR filter (reference: newsched_tpu/ops/fir.py), the parts the
staged flagship's ``vector_fir`` reaches.

A whole batch is filtered at once, carrying the last ``ntaps-1`` input
samples between batches as explicit state:

    y[n] = sum_t taps[t] * x[n - t],   x[<0] = 0

Every function here works along the LAST axis and takes any leading batch
axes, so the M channels of a vector stream are filtered in one batched
product (the reference vmaps its per-channel filter instead).

Compute paths, selected by ``method``:

- ``"mxu"``: frames the output into tiles of 128 and contracts each frame's
  haloed input window against a Toeplitz tap matrix: one
  (frames, F*decim+T-decim) @ (F*decim+T-decim, F) product.
- ``"conv"``: the strided correlation, as windows of the input times the
  reversed taps.

Both run as FP32 matrix products (``torch.matmul``), which is what the
reference's HIGHEST precision asks for; lower precision cost the reference
~18 dB of SNR on the 65-tap audio FIR. The products are plain ops outside
any kernel, as in the reference (XLA's matmul there). ``"fft"`` (and
``"mxu3"``, the reference's bf16x3 tier) come with config #3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


_MXU_FRAME = 128
METHODS = ("auto", "mxu", "conv", "fft", "mxu3")


class FirState(NamedTuple):
    """Inter-batch FIR state: the last ntaps-1 input samples (along the
    last axis; leading axes as the stream's)."""

    tail: torch.Tensor


def fir_init_state(ntaps: int, device, dtype=torch.complex64,
                   batch_shape: tuple = ()) -> FirState:
    return FirState(tail=torch.zeros((*batch_shape, max(ntaps - 1, 0)),
                                     dtype=dtype, device=device))


def _mm(Z: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Z @ H in FP32 real products, for real or complex Z and H (complex
    operands decomposed into planes, as the reference does to keep control
    of precision)."""
    if not Z.is_complex() and not H.is_complex():
        return Z.to(torch.float32) @ H.to(torch.float32)
    if Z.is_complex() and not H.is_complex():
        return torch.complex(Z.real @ H, Z.imag @ H)
    if Z.is_complex():
        zr, zi, hr, hi = Z.real, Z.imag, H.real, H.imag
        return torch.complex(zr @ hr - zi @ hi, zr @ hi + zi @ hr)
    Z = Z.to(torch.float32)
    return torch.complex(Z @ H.real, Z @ H.imag)


def _toeplitz_taps(taps_rev: np.ndarray, frame: int, decim: int) -> np.ndarray:
    """Tap matrix H[s, j] = taps_rev[s - j*decim] (zero outside range).

    Contracting a haloed input frame Z[i, s] (s over (frame-1)*decim + ntaps)
    against H yields y[i*frame + j] = sum_u taps_rev[u] * Z[i, j*decim + u].
    """
    t = np.asarray(taps_rev)
    ntaps = t.shape[0]
    srange = (frame - 1) * decim + ntaps
    H = np.zeros((srange, frame), dtype=t.dtype)
    for j in range(frame):
        H[j * decim: j * decim + ntaps, j] = t
    return H


class FirTaps(NamedTuple):
    """One filter's host taps on a device, for one output length and
    decimation (``fir_taps``)."""

    rev: torch.Tensor       # (ntaps,) the taps reversed, for "conv"
    toeplitz: torch.Tensor  # the "mxu" tap matrix (_toeplitz_taps)


def fir_taps(taps, n_out: int, decim: int, device) -> FirTaps:
    """Host ``taps`` as the device constants of ``fir_filter`` for batches
    of ``n_out`` outputs. Blocks build them once per device and batch
    shape; a direct call of ``fir_filter`` without them builds them for
    that call."""
    taps = np.asarray(taps)
    dtype = np.complex64 if np.iscomplexobj(taps) else np.float32
    rev = np.ascontiguousarray(taps[::-1], dtype)
    H = _toeplitz_taps(rev, min(_MXU_FRAME, n_out), decim)
    return FirTaps(rev=torch.tensor(rev, device=device),
                   toeplitz=torch.tensor(H, device=device))


def _frame_with_halo(xfull: torch.Tensor, nframes: int, stride: int,
                     srange: int) -> torch.Tensor:
    """Z[..., i, s] = xfull[..., i*stride + s] for i < nframes, s < srange
    (zeros past the end of xfull): a strided view where no padding is
    needed."""
    need = (nframes - 1) * stride + srange
    pad = need - int(xfull.shape[-1])
    if pad > 0:
        xfull = torch.cat([xfull, xfull.new_zeros((*xfull.shape[:-1], pad))], -1)
    return xfull.unfold(-1, srange, stride)[..., :nframes, :]


def _mxu_fir(xfull: torch.Tensor, H: torch.Tensor, n_out: int,
             decim: int) -> torch.Tensor:
    """Toeplitz-matmul FIR. xfull includes the ntaps-1 halo at the front;
    H is the tap matrix of ``fir_taps``, (srange, frame)."""
    srange, frame = int(H.shape[0]), int(H.shape[1])
    nframes = -(-n_out // frame)
    Z = _frame_with_halo(xfull, nframes, frame * decim, srange)
    y = _mm(Z, H)  # (..., nframes, frame)
    return y.reshape(*y.shape[:-2], nframes * frame)[..., :n_out]


def _conv1d(x: torch.Tensor, kernel_rev: torch.Tensor, stride: int = 1):
    """Valid-mode correlation along the last axis with an (already
    reversed) kernel: y[..., i] = sum_u kernel_rev[u] * x[..., i*stride + u].
    Windows times the kernel, an FP32 product: a cuDNN convolution would
    run in TF32 on the card by default."""
    K = int(kernel_rev.shape[0])
    Z = x.unfold(-1, K, stride)  # (..., n_windows, K)
    return _mm(Z, kernel_rev[:, None])[..., 0]


def fir_filter(taps, state: FirState, x: torch.Tensor, decim: int = 1,
               method: str = "auto", dev_taps: FirTaps | None = None):
    """Filter one batch along the last axis, threading streaming state.

    Args:
      taps: (ntaps,) float32 or complex64 coefficients (h[0] first): a host
        array (numpy, list) or a tensor.
      state: FirState carrying the previous batch's tail.
      x: (..., B) input batch; B must be a multiple of decim.
      decim: keep every decim-th output (decimating FIR).
      method: "auto" | "mxu" | "conv"; "fft" and "mxu3" are not ported yet.
        "auto" follows the reference: "fft" above 384 taps, "mxu" for host
        taps with decim <= max(4, ntaps // 8), else "conv". Tensor taps
        take "conv" in place of "mxu" (the tap matrix is built from host
        taps).
      dev_taps: ``fir_taps(taps, B // decim, decim, x.device)`` for host
        taps; built here when None.

    Returns (new_state, y) with y of length B // decim along the last axis.
    """
    if method not in METHODS:
        raise ValueError(f"unknown FIR method {method!r}")
    taps_static = not isinstance(taps, torch.Tensor)
    taps_np = np.asarray(taps) if taps_static else None
    ntaps = int(len(taps_np) if taps_static else taps.shape[0])
    B = int(x.shape[-1])
    if B % decim != 0:
        raise ValueError(f"batch size {B} not divisible by decimation {decim}")
    n_out = B // decim
    xfull = torch.cat([state.tail, x], -1) if ntaps > 1 else x
    if method == "auto":
        if ntaps > 384:
            method = "fft"
        elif taps_static and decim <= max(4, ntaps // 8):
            method = "mxu"
        else:
            method = "conv"
    if method in ("fft", "mxu3"):
        raise NotImplementedError(
            f"fir_filter(method={method!r}) comes with config #3, the "
            f"fft_filter slice of the port (ROADMAP Queue 1 item 7)")
    if method == "mxu" and not taps_static:
        method = "conv"  # the tap matrix is built from host taps
    if taps_static and dev_taps is None:
        dev_taps = fir_taps(taps_np, n_out, decim, x.device)
    if method == "mxu":
        y = _mxu_fir(xfull, dev_taps.toeplitz, n_out, decim)
    else:
        rev = dev_taps.rev if taps_static else taps.flip(0)
        y = _conv1d(xfull, rev, stride=decim)[..., :n_out]
    new_tail = xfull[..., -(ntaps - 1):].clone() if ntaps > 1 else state.tail
    return FirState(tail=new_tail), y
