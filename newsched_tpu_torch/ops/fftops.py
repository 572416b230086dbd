"""FFT helpers (reference: newsched_tpu/ops/fftops.py): the fft block's
transform (window, fftshift, forward or inverse) and the Bailey 4-step
fast convolution, the "mxu" engine of the overlap-save filter.

``fft`` is ``torch.fft`` on the last axis: cuFFT on the card.

The Bailey engine factorises a 16384-point transform as 128 x 128, and
the overlap-save filter's whole middle (twiddle, DFT-128 over k2, the
product with the taps' spectrum, the inverse DFT-128, the conjugate
twiddle) collapses into one k1-batched constant matrix

    G3[k1] = diag(T[k1]) (W2 diag(Hm[k1]) W2^-1) diag(conj(T[k1]))

so ifft(fft(x) * H) = W1^-1 @ (W1 @ A) *batched@* G3: three complex
matrix products and no elementwise stage. The constants are
built once per taps in float64 (numpy) and held on the block's device in
complex64. The products run in FP32 (cuBLAS cgemm) with TF32 off whatever
the global flags say: the reference's 3-pass bf16 tier exists for the
TPU's matrix unit, and on the H100 FP32 is the accurate choice.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch


def window_tensor(window, device) -> torch.Tensor:
    """A host window as ``fft`` takes it on ``device`` (float32)."""
    return torch.as_tensor(np.asarray(window, np.float32), device=device)


def fft(x: torch.Tensor, forward: bool = True, window=None,
        shift: bool = False) -> torch.Tensor:
    """Batched FFT over the last axis. x: (..., fft_size); complex64 out.
    ``window`` (fft_size reals: a host array, or ``window_tensor``'s on
    x's device, which a captured step needs) multiplies x first; shift
    applies fftshift to the result."""
    if window is not None:
        w = (window if isinstance(window, torch.Tensor)
             else window_tensor(window, x.device))
        x = x * (w.to(x.dtype) if x.is_complex() else w)
    y = torch.fft.fft(x, dim=-1) if forward else torch.fft.ifft(x, dim=-1)
    if shift:
        y = torch.fft.fftshift(y, dim=-1)
    return y.to(torch.complex64)


@contextlib.contextmanager
def fp32_matmul():
    """Matrix products inside run in FP32: TF32 off for cuBLAS, whatever
    the global flags say, restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# ---------------------------------------------------------------------------
# Bailey 4-step fast convolution

_BAILEY_N1 = 128
_BAILEY_N2 = 128
_BAILEY_N = _BAILEY_N1 * _BAILEY_N2
_bailey_cache: dict = {}


def bailey_supported(ntaps: int, fft_size: int | None) -> bool:
    """The pipeline rounds the overlap-save overlap up to whole N2-lane
    rows, so any ntaps with ceil((ntaps-1)/N2) < N1 fits."""
    return (fft_size in (None, _BAILEY_N)
            and 1 < ntaps and -(-(ntaps - 1) // _BAILEY_N2) < _BAILEY_N1)


def bailey_plan(taps_np: np.ndarray):
    """Constants of the zero-copy overlap-save pipeline, in numpy: the
    overlap is rounded up to R0 = ceil((ntaps-1)/128) whole rows, so every
    segment boundary is row-aligned; the frame build splits into a free
    reshape plus an R0-row correction product (W1 split by columns), and
    the per-segment discard folds into W1inv (rows >= R0). Cached per taps
    (G3 is 128 batched zgemms in float64).

    Returns (W1a (N1, N1-R0), W1b (N1, R0), G3 (N1, N2, N2),
    W1k (N1-R0, N1), R0) as complex64."""
    key = taps_np.tobytes()
    hit = _bailey_cache.get(key)
    if hit is not None:
        return hit
    N1, N2 = _BAILEY_N1, _BAILEY_N2
    ntaps = int(taps_np.shape[0])
    R0 = -(-(ntaps - 1) // N2)
    if not bailey_supported(ntaps, None):
        raise ValueError(f"bailey fast-conv: overlap {R0} rows must be "
                         f"< {N1} (ntaps {ntaps} too long for fft_size "
                         f"{_BAILEY_N})")
    step_rows = N1 - R0
    H = np.fft.fft(taps_np.astype(np.complex128), _BAILEY_N)
    Hm = H.reshape(N2, N1).T  # H[k1 + N1*k2] -> [k1, k2]
    k1 = np.arange(N1)
    k2 = np.arange(N2)
    W1 = np.exp(-2j * np.pi * np.outer(k1, k1) / N1)
    W2 = np.exp(-2j * np.pi * np.outer(k2, k2) / N2)
    T = np.exp(-2j * np.pi * np.outer(k1, k2) / _BAILEY_N)
    # G[k1] = W2 diag(Hm[k1]) W2inv as one batched product
    G = np.matmul(W2[None, :, :] * Hm[:, None, :], np.conj(W2) / N2)
    G3 = T[:, :, None] * G * np.conj(T)[:, None, :]
    W1inv = np.conj(W1) / N1
    plan = (W1[:, :step_rows].astype(np.complex64),
            W1[:, step_rows:].astype(np.complex64),
            G3.astype(np.complex64),
            W1inv[R0:, :].astype(np.complex64), R0)
    if len(_bailey_cache) > 8:  # bound the host memory (~N*N2*8 B a plan)
        _bailey_cache.clear()
    _bailey_cache[key] = plan
    return plan


class BaileyConsts(NamedTuple):
    """``bailey_plan``'s constants on a device (``bailey_consts``)."""

    W1a: torch.Tensor
    W1b: torch.Tensor
    G3: torch.Tensor
    W1k: torch.Tensor
    R0: int
    ntaps: int


def bailey_consts(taps_np: np.ndarray, device) -> BaileyConsts:
    W1a, W1b, G3, W1k, R0 = bailey_plan(np.asarray(taps_np))
    return BaileyConsts(*(torch.tensor(a, device=device)
                          for a in (W1a, W1b, G3, W1k)), R0,
                        int(np.asarray(taps_np).shape[0]))


def bailey_filter(xfull: torch.Tensor, consts: BaileyConsts,
                  n_lin: int) -> torch.Tensor:
    """Overlap-save FIR by the Bailey fast convolution along the last axis:
    y[..., k] = sum_t taps[t] xfull[..., ntaps-1+k-t] for k < n_lin.

    xfull: (..., >= n_lin + ntaps - 1) complex64 with the ntaps-1 halo at
    the front (ops/fir.py's streaming convention). Three batched complex
    products and one R0-row gather (a strided view): no frame is
    materialised and the discard is W1inv's rows."""
    N1, N2 = _BAILEY_N1, _BAILEY_N2
    R0, ntaps = consts.R0, consts.ntaps
    step_rows = N1 - R0
    step = step_rows * N2
    nseg = -(-n_lin // step)
    # segment 0's first kept output (matrix row R0) must be convolution
    # output 0, at xfull position ntaps-1: front-pad by R0*N2 - (ntaps-1)
    pad_front = R0 * N2 - (ntaps - 1)
    need = nseg * step + _BAILEY_N
    pad_back = max(need - (int(xfull.shape[-1]) + pad_front), 0)
    xc = torch.nn.functional.pad(xfull.to(torch.complex64),
                                 (pad_front, pad_back))
    lead = xc.shape[:-1]
    U = xc[..., : (nseg * step_rows + R0) * N2].reshape(*lead, -1, N2)
    Vmain = U[..., : nseg * step_rows, :].reshape(*lead, nseg, step_rows, N2)
    # segment s's head rows are U rows s*step_rows + step_rows + [0, R0)
    Vhead = U[..., step_rows:, :].unfold(-2, R0, step_rows).transpose(-1, -2)
    with fp32_matmul():
        B = consts.W1a @ Vmain + consts.W1b @ Vhead  # (..., nseg, N1, N2)
        # C[..., s, k, :] = B[..., s, k, :] @ G3[k]: batched over k
        C = (B.transpose(-3, -2) @ consts.G3).transpose(-3, -2)
        y = consts.W1k @ C  # (..., nseg, N1 - R0, N2)
    return y.reshape(*lead, -1)[..., :n_lin]
