"""Polyphase filterbank: channelizer and decimator (reference:
newsched_tpu/ops/pfb.py).

The maximally-decimated M-channel analysis bank is built so that every
channel k is *mathematically identical* to
``decimate_M(lowpass(x * exp(-j 2 pi k n / M)))``:

    y_k[m] = sum_t h[t] x[mM - t] e^{+j 2 pi k t / M}
           = sum_{p=0}^{M-1} e^{j 2 pi k p / M} * (g_p (*) u_p)[m]
    with arm taps    g_p[l] = h[lM + p]
    and arm signals  u_p[i] = x[iM - p]

i.e. per-arm streaming FIRs followed by an M-point inverse DFT across arms
(times M). Kept layout-preserving as in the reference: the commutator
matrix V[i, q] = xfull[i*M + q] is folded down its columns with
c[s, q] = arm[M-1-q, L-1-s] (the arm fold, K7 ``arm_fold``), and the
combine is an FFT along q times the twiddle e^{-j2pi k/M}, or both in one
kernel (K1 ``arm_fold_dft``, ops/cuda/channelizer.py).

Streaming state is the last M*L-1 raw input samples, so batch-split
invariance holds exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import channelizer
from newsched_tpu_torch.ops.cuda.planes_fft import CHANNELS, planes_fft_table

METHODS = ("auto", "fused", "pallas", "sum")
# The widest channel count "auto" takes K1 at: past it K7 + cuFFT's
# combine was the faster on the H100 at 576 .. 1024 but for 704, where K1
# won by 0.012 ms of 0.22 (PERF.md, chip_smoke.py phase 49)
AUTO_K1_MAX = 512


class PfbState(NamedTuple):
    tail: torch.Tensor  # last M*L-1 input samples


class PfbConsts(NamedTuple):
    """One channelizer's constants on one device (``pfb_consts``)."""

    c: torch.Tensor        # (L, M) fold coefficients c[s, q] = arm[M-1-q, L-1-s]
    c2: torch.Tensor       # (L, 2M) the same on the interleaved lanes
    w2: torch.Tensor       # (2M, 2M) interleaved DFT matrix, twiddle absorbed
    twiddle: torch.Tensor  # (M,) complex64 e^{-j 2 pi k / M}
    fft: torch.Tensor | None  # (4, M) K1's FFT table (planes_fft_table)


def pfb_arm_taps(taps: np.ndarray, nchans: int) -> np.ndarray:
    """Partition prototype taps into per-arm taps g[p, l] = h[l*M + p].

    Pads the prototype with zeros up to a multiple of nchans (same as the
    reference, which rounds the prototype up to fill all arms).
    """
    taps = np.asarray(taps)
    L = -(-taps.shape[0] // nchans)
    padded = np.zeros(L * nchans, dtype=taps.dtype)
    padded[: taps.shape[0]] = taps
    return padded.reshape(L, nchans).T.copy()  # (M, L)


def pfb_init_state(ntaps_total: int, device, dtype=torch.complex64) -> PfbState:
    return PfbState(tail=torch.zeros((ntaps_total - 1,), dtype=dtype,
                                     device=device))


def pfb_consts(arm_taps, device) -> PfbConsts:
    """The constants of the channelizer with these (M, L) arm taps, on
    ``device``. The blocks build them once per device; a direct call of
    ``pfb_channelize`` without them builds them for that call."""
    M = int(arm_taps.shape[0])
    c = np.ascontiguousarray(np.asarray(arm_taps, np.float32)[::-1, ::-1].T)
    k = np.arange(M)
    fft = planes_fft_table(M)
    return PfbConsts(
        c=torch.tensor(c, device=device),
        c2=torch.tensor(channelizer.interleave_taps(c), device=device),
        w2=torch.tensor(channelizer.interleaved_dft_matrix(M), device=device),
        twiddle=torch.tensor(np.exp(-2j * np.pi * k / M).astype(np.complex64),
                             device=device),
        fft=None if fft is None else torch.tensor(fft, device=device))


def _commutator(arm_taps, state: PfbState, x: torch.Tensor):
    """(xfull, V (L-1+n_out, M) complex64 view, n_out) for one batch."""
    M, L = int(arm_taps.shape[0]), int(arm_taps.shape[1])
    B = int(x.shape[0])
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by nchans {M}")
    n_out = B // M
    xfull = torch.cat([state.tail, x])
    V = xfull[: (L - 1 + n_out) * M].reshape(L - 1 + n_out, M)
    return xfull, V, n_out


def _fold(V: torch.Tensor, consts: PfbConsts, n_out: int, method: str):
    """The arm fold of V: "fused" (with the combine, K1), "pallas" (K7) or
    "sum" (L shifted multiply-adds)."""
    if method == "sum":
        acc = torch.zeros((n_out, V.shape[1]), dtype=torch.complex64,
                          device=V.device)
        for s in range(consts.c.shape[0]):
            acc = acc + consts.c[s] * V[s:s + n_out]
        return acc
    v = channelizer.complex_to_interleaved(V)
    out = (channelizer.arm_fold_dft(v, consts.c2, consts.w2, n_out,
                                    fft=consts.fft)
           if method == "fused" else channelizer.arm_fold(v, consts.c2, n_out))
    return channelizer.interleaved_to_complex(out)


def pfb_channelize(arm_taps, state: PfbState, x: torch.Tensor,
                   method: str = "auto", combine: str = "auto",
                   consts: PfbConsts | None = None):
    """Channelize one batch.

    Args:
      arm_taps: (M, L) float32 polyphase partition from pfb_arm_taps.
      state: PfbState with M*L-1 tail samples.
      x: (B,) complex64, B % M == 0.
      method: "fused" (fold + combine in one kernel, K1 ``arm_fold_dft``,
        which on the card takes M = 64 P, P = 1 .. 16, 64 to 1024
        channels), "pallas" (the fold kernel K7 ``arm_fold``, then the
        combine), "sum" (shifted multiply-adds, then the combine), or
        "auto" (``auto_method``): "fused" at K1's widths
        (``planes_fft.CHANNELS``) up to ``AUTO_K1_MAX`` = 512, else
        "pallas" (K7 takes any width, then cuFFT's combine). The reference
        takes K1 on a TPU and "sum" elsewhere. The kernels' wrappers run their plain versions on CPU
        tensors.
      combine: "fft", "matmul" or "auto" (= "fft"); "fused" has its own.
      consts: ``pfb_consts(arm_taps, x.device)``; built here when None.

    Returns (new_state, Y) where Y is (B//M, M) complex64: item m is the M
    channel outputs at channel-rate sample index m; channel k is centered
    at k/M of the input rate (k > M/2 are negative frequencies).
    """
    M, L = int(arm_taps.shape[0]), int(arm_taps.shape[1])
    if method not in METHODS:
        raise ValueError(f"unknown pfb method {method!r}")
    xfull, V, n_out = _commutator(arm_taps, state, x)
    new_state = PfbState(tail=xfull[-(M * L - 1):].clone())
    if consts is None:
        consts = pfb_consts(arm_taps, x.device)
    if method == "auto":
        method = auto_method(M)
    acc = _fold(V, consts, n_out, method)
    if method == "fused":
        return new_state, acc
    return new_state, _phase_combine(acc, consts, combine)


def auto_method(M: int) -> str:
    """``pfb_channelize``'s "auto" route at M channels: "fused" (K1 on its
    planes FFT) at M in ``planes_fft.CHANNELS`` up to ``AUTO_K1_MAX``,
    else "pallas" (K7, then the combine), which past 512 was the faster
    of the two on the H100 (chip_smoke.py phase 49 times both)."""
    return "fused" if M in CHANNELS and M <= AUTO_K1_MAX else "pallas"


def _phase_combine(acc: torch.Tensor, consts: PfbConsts,
                   combine: str) -> torch.Tensor:
    """The across-arms combine: y[:, k] = twiddle[k] * FFT_q(acc)[:, k]
    with twiddle = e^{-j 2 pi k / M}.

    combine="fft" (and "auto"): torch.fft and the twiddle multiply.
    combine="matmul": the (M, M) complex DFT matrix with the twiddle
    absorbed (the real and imaginary parts are views of the interleaved
    matrix), as four real FP32 products. Both are plain ops outside any
    kernel, as in the reference (XLA's FFT and matmul there)."""
    if combine == "auto":
        combine = "fft"
    if combine == "fft":
        return torch.fft.fft(acc, dim=-1) * consts.twiddle
    if combine != "matmul":
        raise ValueError(f"unknown pfb combine {combine!r}")
    # W[q, k] = e^{-j 2 pi q k / M} * tw[k]; FFT convention: X_k = sum_q x_q W
    Wr, Wi = consts.w2[0::2, 0::2], consts.w2[0::2, 1::2]
    ar, ai = acc.real, acc.imag
    return torch.complex(ar @ Wr - ai @ Wi, ar @ Wi + ai @ Wr)


def pfb_decimate(arm_taps, state: PfbState, x: torch.Tensor, channel: int,
                 method: str = "auto", consts: PfbConsts | None = None):
    """Single-channel polyphase decimator (reference: pfb_decimator):
    extract channel `channel` of the M-channel bank without computing the
    other M-1 channels — the phase combine for one k is a single weighted
    sum over arms, y = acc @ w_k (one FP32 matvec instead of an FFT), with
    w_k column k of the combine's DFT matrix.

    method: "pallas" (the fold kernel K7 ``arm_fold``; "auto" picks it, and
    its wrapper runs the plain version on CPU tensors) or "sum".
    consts: ``pfb_consts(arm_taps, x.device)``; built here when None."""
    M, L = int(arm_taps.shape[0]), int(arm_taps.shape[1])
    if method not in ("auto", "pallas", "sum"):
        raise ValueError(f"unknown pfb_decimate method {method!r}")
    k = int(channel) % M
    xfull, V, n_out = _commutator(arm_taps, state, x)
    if consts is None:
        consts = pfb_consts(arm_taps, x.device)
    acc = _fold(V, consts, n_out, "sum" if method == "sum" else "pallas")
    wr, wi = consts.w2[0::2, 2 * k], consts.w2[0::2, 2 * k + 1]
    ar, ai = acc.real, acc.imag
    y = torch.complex(ar @ wr - ai @ wi, ar @ wi + ai @ wr)
    return PfbState(tail=xfull[-(M * L - 1):].clone()), y
