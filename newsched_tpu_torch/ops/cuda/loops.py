"""S1 ``costas_loop`` and S2 ``clock_recovery_mm``: the digital receiver's
two per-sample feedback loops (reference: newsched_tpu/ops/loops.py
``costas_loop``, its ``lax.scan`` at ``:121``, and ``clock_recovery_mm``,
its ``lax.scan`` at ``:218``). Neither has a TPU kernel: the reference
runs each as a scan, which torch cannot express, so each is a CUDA kernel
here (``csrc/loops.cu``), one thread per stream, with its plain PyTorch
version beside it: a torch loop over the samples with the reference's
operations in the reference's order, every stream of a batch at once.

Inputs are (C, N) complex64 streams; the state is one value per stream.
On CPU tensors each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. The loop gains may be 0-dim float32
tensors on the card (settable block parameters: the kernels read them
there, so a captured graph replays a changed value), or host numbers.

The kernel spells each multiply and add as a separately rounded operation
(``__fmul_rn``/``__fadd_rn``), as torch's elementwise ops round them, so
S2 equals its plain version bit for bit and S1 differs from its plain
version only where CUDA's ``sincosf`` and torch's sin/cos differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build

TWO_PI = float(np.float32(2.0 * np.pi))
DAMPING = float(np.float32(math.sqrt(2.0) / 2.0))
K8 = float(np.float32(math.sqrt(2.0) - 1.0))  # the order-8 detector's k
ORDERS = (2, 4, 8)
MM_SLICE = 256           # window samples of a stream staged a chunk (S2)
MM_MARGIN = 16           # a slice starts this far before the predicted read


def wrap_phase(p: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]: p - 2 pi round(p / 2 pi), round half to even. The
    divisor is a tensor on p's device: torch takes a division by a host
    scalar as a product with its reciprocal on the card."""
    two_pi = torch.full_like(p, TWO_PI)
    return p - two_pi * torch.round(p / two_pi)


def costas_error(re: torch.Tensor, im: torch.Tensor, order: int):
    """The decision-directed phase detector of an order-2, 4 or 8 PSK loop."""
    sre = torch.where(re >= 0, 1.0, -1.0).to(torch.float32)
    sim = torch.where(im >= 0, 1.0, -1.0).to(torch.float32)
    if order == 2:
        return re * im
    if order == 4:
        return sre * im - sim * re
    if order == 8:
        return torch.where(re.abs() >= im.abs(), sre * im - sim * re * K8,
                           sre * im * K8 - sim * re)
    raise ValueError(f"costas order must be 2, 4, or 8 (got {order})")


def costas_coeffs(bw: torch.Tensor):
    """(alpha, beta) of a 0-dim float32 loop bandwidth, in float32, in the
    reference's order for a traced ``loop_bw``."""
    denom = 1.0 + (2.0 * DAMPING) * bw + bw * bw
    return (4.0 * DAMPING) * bw / denom, (4.0 * bw) * bw / denom


def _gain(g, device) -> torch.Tensor:
    return torch.as_tensor(g, dtype=torch.float32, device=device)


def costas_loop_plain(x, phase, freq, bw, alpha: float, beta: float,
                      order: int, max_freq: float):
    """The plain version: x (C, N) complex64, phase and freq (C,) float32;
    ``bw`` a 0-dim float32 tensor (then alpha and beta come from it) or
    None (then the host's ``alpha``, ``beta``). Returns (y, phase, freq)."""
    if bw is not None:
        a, b = costas_coeffs(_gain(bw, x.device))
    else:
        a, b = _gain(alpha, x.device), _gain(beta, x.device)
    maxf = float(np.float32(max_freq))
    v = torch.view_as_real(x.contiguous())
    y = torch.empty_like(v)
    for n in range(x.shape[-1]):
        c, s = torch.cos(-phase), torch.sin(-phase)
        xr, xi = v[:, n, 0], v[:, n, 1]
        re = xr * c - xi * s
        im = xr * s + xi * c
        y[:, n, 0], y[:, n, 1] = re, im
        e = torch.clamp(costas_error(re, im, order), -1.0, 1.0)
        freq = torch.clamp(freq + b * e, -maxf, maxf)
        phase = wrap_phase(phase + freq + a * e)
    return torch.view_as_complex(y), phase, freq


def _check_c64(t, name, device, shape) -> None:
    if t.device != device or t.dtype != torch.complex64 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"the kernel takes contiguous complex64 {shape} on "
                         f"{device}")


def costas_loop(x, phase, freq, bw, alpha: float, beta: float, order: int,
                max_freq: float):
    """S1: the plain version for CPU tensors, ``costas_launch`` for CUDA
    tensors (``costas_loop_plain``'s arguments and results)."""
    if x.device.type == "cpu":
        return costas_loop_plain(x, phase, freq, bw, alpha, beta, order,
                                 max_freq)
    if order not in ORDERS:
        raise ValueError(f"costas order must be 2, 4, or 8 (got {order})")
    lib = _build.lib()  # raises where the kernels cannot be built
    C, N = x.shape
    _check_c64(x, "x", x.device, (C, N))
    _build.check_tensor(phase, "phase", device=x.device, shape=(C,))
    _build.check_tensor(freq, "freq", device=x.device, shape=(C,))
    bw_ptr = 0
    if bw is not None:
        bw_ptr, _ = _build.scalar_arg(bw, "loop_bw", x.device)
    y = torch.empty_like(x)
    ph, fr = torch.empty_like(phase), torch.empty_like(freq)
    with torch.cuda.device(x.device):
        err = lib.costas_launch(
            x.data_ptr(), y.data_ptr(), phase.data_ptr(), freq.data_ptr(),
            ph.data_ptr(), fr.data_ptr(), bw_ptr, float(np.float32(alpha)),
            float(np.float32(beta)), float(np.float32(max_freq)), DAMPING, K8,
            TWO_PI, order, C, N, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "costas_launch")
    costas_loop.launches += 1
    return y, ph, fr


costas_loop.launches = 0


def _window_pair(wv, i0):
    """window[i0] and window[i0 + 1] of every stream (wv the (C, wlen, 2)
    float view), as (re, im) pairs."""
    rows = torch.arange(wv.shape[0], device=wv.device)
    a0, a1 = wv[rows, i0], wv[rows, i0 + 1]
    return a0[:, 0], a0[:, 1], a1[:, 0], a1[:, 1]


def clock_recovery_mm_plain(x, hist, pos, mu, omega, p1, p2, c1, c2, sps: int,
                            gain_omega, gain_mu, omega_relative_limit: float):
    """The plain version: x (C, N) complex64, hist (C, H) complex64, pos
    (C,) int64, mu, omega (C,) float32, p1, p2, c1, c2 (C,) complex64.
    Returns (y (C, N // sps), hist, pos, mu, omega, p1, p2, c1, c2)."""
    C, N = x.shape
    H = hist.shape[-1]
    nout = N // sps
    window = torch.cat([hist, x], -1)
    wlen = H + N
    wv = torch.view_as_real(window)
    g_om, g_mu = _gain(gain_omega, x.device), _gain(gain_mu, x.device)
    om_mid = float(np.float32(sps))
    om_lim = float(np.float32(om_mid) * np.float32(omega_relative_limit))
    p1r, p1i, p2r, p2i = p1.real, p1.imag, p2.real, p2.imag
    c1r, c1i, c2r, c2i = c1.real, c1.imag, c2.real, c2.imag
    y = torch.empty((C, nout, 2), dtype=torch.float32, device=x.device)
    for k in range(nout):
        # dynamic_slice clamps the start into the window
        a0r, a0i, a1r, a1i = _window_pair(wv, torch.clamp(pos, 0, wlen - 2))
        p0r = a0r + (a1r - a0r) * mu
        p0i = a0i + (a1i - a0i) * mu
        c0r = torch.where(p0r >= 0, 1.0, -1.0).to(torch.float32)
        c0i = torch.where(p0i >= 0, 1.0, -1.0).to(torch.float32)
        # Re{(p0 - p2) conj(c1) - (c0 - c2) conj(p1)}
        d1r, d1i = p0r - p2r, p0i - p2i
        d2r, d2i = c0r - c2r, c0i - c2i
        e = torch.clamp((d1r * c1r + d1i * c1i) - (d2r * p1r + d2i * p1i),
                        -1.0, 1.0)
        omega = om_mid + torch.clamp(omega + g_om * e - om_mid, -om_lim, om_lim)
        step = mu + omega + g_mu * e
        ipart = torch.floor(step)
        mu = step - ipart
        pos = pos + ipart.to(torch.int64)
        y[:, k, 0], y[:, k, 1] = p0r, p0i
        p2r, p2i, p1r, p1i = p1r, p1i, p0r, p0i
        c2r, c2i, c1r, c1i = c1r, c1i, c0r, c0i
    pos = torch.clamp(pos - (wlen - H), 0, 2 * H)
    return (torch.view_as_complex(y), window[:, wlen - H:].contiguous(), pos,
            mu, omega, torch.complex(p1r, p1i), torch.complex(p2r, p2i),
            torch.complex(c1r, c1i), torch.complex(c2r, c2i))


def mm_chunk_steps(sps: int) -> int:
    """Symbols a chunk of S2: the steps whose window reads fit one staged
    slice of MM_SLICE samples, MM_MARGIN of it before the predicted read
    position, at a step of up to sps + 2 samples (a read outside it, which
    no gain of the reference gives, goes to device memory instead); at most
    64, the kernel's buffer of symbols."""
    return max(1, min(64, (MM_SLICE - 2 - MM_MARGIN) // (int(sps) + 2)))


def clock_recovery_mm(x, hist, pos, mu, omega, p1, p2, c1, c2, sps: int,
                      gain_omega, gain_mu, omega_relative_limit: float):
    """S2: the plain version for CPU tensors, ``mm_launch`` for CUDA
    tensors (``clock_recovery_mm_plain``'s arguments and results)."""
    if x.device.type == "cpu":
        return clock_recovery_mm_plain(x, hist, pos, mu, omega, p1, p2, c1, c2,
                                       sps, gain_omega, gain_mu,
                                       omega_relative_limit)
    lib = _build.lib()  # raises where the kernels cannot be built
    dev = x.device
    C, N = x.shape
    H = hist.shape[-1]
    nout = N // sps
    _check_c64(x, "x", dev, (C, N))
    _check_c64(hist, "hist", dev, (C, H))
    for name, t in (("p1", p1), ("p2", p2), ("c1", c1), ("c2", c2)):
        _check_c64(t, name, dev, (C,))
    _build.check_tensor(mu, "mu", device=dev, shape=(C,))
    _build.check_tensor(omega, "omega", device=dev, shape=(C,))
    if pos.device != dev or pos.dtype != torch.int64 or tuple(pos.shape) != (C,):
        raise ValueError(f"pos: {pos.dtype} {tuple(pos.shape)} on {pos.device},"
                         f" the kernel takes int64 ({C},) on {dev}")
    g_om_ptr, g_om = _build.scalar_arg(gain_omega, "gain_omega", dev)
    g_mu_ptr, g_mu = _build.scalar_arg(gain_mu, "gain_mu", dev)
    om_mid = np.float32(sps)
    om_lim = float(om_mid * np.float32(omega_relative_limit))
    y = torch.empty((C, nout), dtype=torch.complex64, device=dev)
    out = [torch.empty_like(t) for t in (pos, mu, omega, p1, p2, c1, c2)]
    with torch.cuda.device(dev):
        err = lib.mm_launch(
            x.data_ptr(), hist.data_ptr(), pos.data_ptr(), mu.data_ptr(),
            omega.data_ptr(), p1.data_ptr(), p2.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in out),
            g_om_ptr, g_mu_ptr, g_om, g_mu, float(om_mid), om_lim, sps, C, N,
            H, mm_chunk_steps(sps), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mm_launch")
    clock_recovery_mm.launches += 1
    # the next batch's history: the window's last H samples
    new_hist = (x[:, N - H:] if N >= H
                else torch.cat([hist[:, N:], x], -1)).contiguous()
    return (y, new_hist, *out)


clock_recovery_mm.launches = 0
