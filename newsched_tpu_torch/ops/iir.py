"""Streaming IIR filter (reference: newsched_tpu/ops/iir.py): S4 on the
card, a chunked matrix form as its plain version.

On a CUDA tensor ``iir_filter`` launches S4 (ops/cuda/scan.py
``iir_scan``, csrc/scan.cu): one launch computes the feed-forward taps
(up to 32 of them; with more they run as ``fir_filter`` "conv" first, as
the reference computes them), the recurrence and the new state; past
feedback order 16 it raises (ROADMAP Queue 3, R3). On a CPU tensor it runs
the plain version, ``iir_filter_plain``, below.

The plain version splits the recurrence as the reference does:

  1. the feed-forward (FIR) part runs through ``fir_filter`` ("conv");
  2. the autoregressive part  y[n] = v[n] + sum_k fb[k] y[n-1-k]  is solved
     exactly for the whole batch. The reference uses ``lax.associative_scan``
     over affine maps (log2(n) passes); torch has no associative scan, so
     here the batch is cut into K chunks of C samples and solved by a fixed
     handful of matrix products, whatever n:

       - within a chunk, from a zero state: Y0 = V @ T^T, T the C x C lower
         triangular Toeplitz matrix of the AR impulse response h;
       - the chunk-start states z_j = [y, ..., y[-order+1]] before chunk j:
         z_{j+1} = Phi z_j + E_j with Phi = A^C (A the companion matrix) and
         E_j the last `order` outputs of Y0's row j, all at once as
         Z = Q z_0 + P E, P the block lower-triangular matrix of the powers
         Phi^(j-1-i) and Q the column of the powers Phi^j;
       - Y = Y0 + Z @ S^T, S[i] the first row of A^(i+1) (the response of
         sample i to the chunk's start state).

     The constants are built once per (taps, batch length) in float64
     (numpy) and used in float32; the products run in FP32 (TF32 off).

Convention (gr::kernel::filter::iir_filter):
  y[n] = sum_k ff[k] x[n-k] + sum_{k>=1} fb[k] y[n-k]
(scipy.signal.lfilter(b, a): ff = b/a[0], fb[k] = -a[k]/a[0].)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops import fir as fir_ops
from newsched_tpu_torch.ops.cuda import scan as kscan
from newsched_tpu_torch.ops.fftops import fp32_matmul

_MAX_CHUNK = 1024
_MAX_STATES = 1024  # K * order the chunk length aims to stay within


class IirState(NamedTuple):
    fir: fir_ops.FirState  # input history for the feed-forward taps
    y_hist: torch.Tensor   # last `order` outputs, y_hist[0] = y[n-1]


def iir_init_state(ff_ntaps: int, fb_order: int, device,
                   dtype=torch.float32) -> IirState:
    return IirState(fir=fir_ops.fir_init_state(ff_ntaps, device, dtype),
                    y_hist=torch.zeros((fb_order,), dtype=dtype, device=device))


def chunk_length(n: int, order: int) -> int:
    """C: the least power of two >= max(order, 16) that keeps K * order
    (K = ceil(n / C) chunks) within 1024, at most 1024."""
    C = 16
    while C < order:
        C *= 2
    while C < _MAX_CHUNK and -(-n // C) * order > _MAX_STATES:
        C *= 2
    return C


class IirConsts(NamedTuple):
    """One filter's constants on a device for batches of n samples
    (``iir_consts``): the chunk form's (``chunk_consts``), or on the card
    S4's (``scan``) in place of C, K, T, S, P and Q."""

    ff: fir_ops.FirTaps | None  # the feed-forward taps ("conv"), where a
                                # torch op applies them
    n: int                # the batch length they are built for
    C: int
    K: int
    T: torch.Tensor | None  # (C, C) impulse-response Toeplitz, transposed
    S: torch.Tensor | None  # (C, order) state response, transposed: (order, C)
    P: torch.Tensor | None  # (K*order, K*order) powers of Phi, transposed
    Q: torch.Tensor | None  # (order, K*order) Phi^j, transposed
    scan: kscan.ScanConsts | None = None


def _ar_matrices(fb: np.ndarray, C: int, K: int):
    """T, S, P, Q of the module docstring in float64, transposed for
    right-multiplication of row vectors."""
    order = len(fb)
    A = np.zeros((order, order))
    A[0, :] = fb
    A[np.arange(1, order), np.arange(order - 1)] = 1.0
    pows = [np.eye(order)]
    for _ in range(C):
        pows.append(A @ pows[-1])
    h = np.array([p[0, 0] for p in pows[:C]])  # h[m] = (A^m)[0, 0]
    i = np.arange(C)
    d = i[:, None] - i[None, :]
    T = np.where(d >= 0, h[np.clip(d, 0, None)], 0.0)  # T[i, j] = h[i - j]
    S = np.stack([pows[m + 1][0, :] for m in range(C)])  # (C, order)
    Phi = pows[C]
    phis = [np.eye(order)]
    for _ in range(K):
        phis.append(Phi @ phis[-1])
    phis = np.stack(phis)  # (K+1, order, order)
    j = np.arange(K)
    e = j[:, None] - 1 - j[None, :]  # block (j, i) = Phi^(j-1-i), i < j
    blocks = np.where((e >= 0)[:, :, None, None], phis[np.clip(e, 0, None)],
                      0.0)  # (K, K, order, order)
    P = blocks.transpose(0, 2, 1, 3).reshape(K * order, K * order)
    Q = phis[:K].reshape(K * order, order)
    return T.T, S.T, P.T, Q.T


def iir_consts(ff_taps, fb_taps, n: int, device) -> IirConsts:
    """The constants ``iir_filter`` takes on ``device``: S4's on the card
    (``kscan.scan_consts``, its workspace included, so each block instance
    keeps its own), the chunk form's elsewhere."""
    if torch.device(device).type != "cuda":
        return chunk_consts(ff_taps, fb_taps, n, device)
    sc = kscan.scan_consts(ff_taps, fb_taps, n, device)
    ft = (fir_ops.fir_taps(np.asarray(ff_taps), n, 1, device, method="conv")
          if sc.fir_outside else None)
    return IirConsts(ft, n, 0, 0, None, None, None, None, scan=sc)


def chunk_consts(ff_taps, fb_taps, n: int, device) -> IirConsts:
    """The plain version's constants on any device."""
    ff = np.asarray(ff_taps)
    fb = np.asarray(fb_taps, np.float64)
    order = len(fb)
    ft = fir_ops.fir_taps(ff, n, 1, device, method="conv")
    if order == 0:
        return IirConsts(ft, n, n, 1, None, None, None, None)
    C = chunk_length(n, order)
    K = -(-n // C)
    mats = (torch.tensor(m, dtype=torch.float32, device=device)
            for m in _ar_matrices(fb, C, K))
    return IirConsts(ft, n, C, K, *mats)


def _mm(Z: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Z @ H for a real H and a real or complex Z, in FP32."""
    with fp32_matmul():
        if Z.is_complex():
            return torch.complex(Z.real @ H, Z.imag @ H)
        return Z @ H


def _ar_chunked(v: torch.Tensor, y_hist: torch.Tensor, c: IirConsts):
    """y[n] = v[n] + sum_k fb[k] y[n-1-k] over the batch from the state
    ``y_hist``: the chunk form of the module docstring."""
    n, order, C, K = int(v.shape[0]), int(y_hist.shape[0]), c.C, c.K
    V = torch.nn.functional.pad(v, (0, K * C - n)).reshape(K, C)
    Y0 = _mm(V, c.T)                                   # (K, C)
    E = Y0[:, C - order:].flip(-1).reshape(1, K * order)
    Z = _mm(E, c.P) + _mm(y_hist[None], c.Q)           # (1, K*order)
    y = (Y0 + _mm(Z.reshape(K, order), c.S)).reshape(-1)[:n]
    full = torch.cat([y_hist.flip(0), y]) if n < order else y
    return y, full[-order:].flip(0)


def iir_filter(ff_taps, fb_taps, state: IirState, x: torch.Tensor,
               consts: IirConsts | None = None):
    """Filter one batch x (n,), float32 or complex64 (real taps). ff_taps:
    (nff,), fb_taps: (order,) with fb_taps[k] multiplying y[n-1-k] (host
    arrays). ``consts``: ``iir_consts(ff_taps, fb_taps, n, x.device)``,
    built here when None. S4 on a CUDA tensor, the plain version on a CPU
    one. Returns (new_state, y)."""
    n = int(x.shape[-1])
    if consts is None:
        consts = iir_consts(ff_taps, fb_taps, n, x.device)
    if x.device.type == "cpu":
        return iir_filter_plain(ff_taps, fb_taps, state, x, consts)
    if consts.n != n:
        raise ValueError(f"IIR constants built for batches of {consts.n}, "
                         f"got {n}")
    sc = consts.scan
    if sc is None:
        raise ValueError("iir_filter on the card takes iir_consts(..., "
                         "device=<a CUDA device>), S4's constants")
    x = x.contiguous()
    if not sc.fir_outside:
        y, tail, y_hist = kscan.iir_scan(x, state.fir.tail.contiguous(),
                                         state.y_hist.contiguous(), sc)
        return IirState(fir=fir_ops.FirState(tail=tail), y_hist=y_hist), y
    fir_state, v = fir_ops.fir_filter(ff_taps, state.fir, x, method="conv",
                                      dev_taps=consts.ff)
    y, _, y_hist = kscan.iir_scan(v.to(x.dtype).contiguous(), x.new_empty(0),
                                  state.y_hist.contiguous(), sc)
    return IirState(fir=fir_state, y_hist=y_hist), y


def iir_filter_plain(ff_taps, fb_taps, state: IirState, x: torch.Tensor,
                     consts: IirConsts | None = None):
    """The plain version, on any device: ``fir_filter`` "conv", then the
    chunk form (``consts``: ``chunk_consts``, built here when None)."""
    n = int(x.shape[-1])
    if consts is None:
        consts = chunk_consts(ff_taps, fb_taps, n, x.device)
    if consts.scan is not None:
        raise ValueError("iir_filter_plain takes chunk_consts, not S4's")
    if consts.n != n:
        raise ValueError(f"IIR constants built for batches of {consts.n}, "
                         f"got {n}")
    fir_state, v = fir_ops.fir_filter(ff_taps, state.fir, x, method="conv",
                                      dev_taps=consts.ff)
    v = v.to(x.dtype)
    if consts.T is None:  # no feedback taps: the FIR alone
        return IirState(fir=fir_state, y_hist=state.y_hist), v
    y, y_hist = _ar_chunked(v, state.y_hist, consts)
    return IirState(fir=fir_state, y_hist=y_hist), y


def lfilter_taps(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Convert scipy (b, a) to (ff, fb) in this module's convention."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    ff = (b / a[0]).astype(np.float32)
    fb = (-a[1:] / a[0]).astype(np.float32)
    return ff, fb
