"""The fused kernels' polynomial math functions (reference:
newsched_tpu/ops/pallas/mathfns.py ``atan2``, deg=9, and
``sin_cos_turns``).

Their CUDA forms are ``__device__`` functions in ``csrc/mathfns.cuh``,
shared by every kernel that needs them; ``atan2`` here launches the
first over a whole tensor (K2 alone, ``atan2_launch`` in
``csrc/fm_chain.cu``), so the card can check and time it against the
plain version and ``torch.atan2``. The launch is shaped for the memory
system, which bounds it (12 bytes an element, ~28 flops): one pass of a
grid in which each thread loads 4 consecutive y and 4 x as two 16-byte
words, both before any arithmetic, and stores its 4 angles as one, its
first threads taking the < 4 elements past the last whole word; where y,
x or the output lies off the 16-byte grid (a view), one element a
thread. The device function computes

    z = min(|x|,|y|) / max(|x|,|y|)          z in [0, 1]
    a = atan(z)      via odd polynomial in z
    a = pi/2 - a     if |y| > |x|
    a = pi  - a      if x < 0
    a = -a           if y < 0
    a = 0            if x == y == 0 (either sign of zero)

The coefficients are the reference's least-squares fit on Chebyshev nodes
(float64, then cast), degree 9 in z^2: < 1e-7 max error on [0, 1].

``sin_cos_turns`` evaluates (sin, cos)(2*pi*t) of float32 turns t with
the reference's quarter-wave polynomials (degree 5 in f^2, ~3e-7 max
error): t - floor(t), the quadrant q = floor(4t) and the quarter phase
f = 4t - q, with q = 4 wrapped to 0 (t a hair below a whole turn rounds
t - floor(t) to exactly 1.0). The CUDA form spells every multiply and add
as a separately rounded operation, as torch's elementwise ops round them,
so kernel and plain version agree bit for bit. Both coefficient sets go
to the kernels from the host, so both use identical float32 values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build

DEG = 9


def _fit_atan_coeffs(deg: int) -> np.ndarray:
    """atan(z) ~ z * sum_k c[k] * (z^2)^k on [0, 1] (c[0] ~ 1)."""
    n = 2048
    # Chebyshev nodes mapped to (0, 1] — dense near the tricky z=1 end.
    z = (1 - np.cos(np.pi * (np.arange(n) + 0.5) / n)) / 2
    z = np.clip(z, 1e-9, 1.0)
    w = z * z
    A = np.stack([z * w**k for k in range(deg + 1)], axis=1)
    c, *_ = np.linalg.lstsq(A, np.arctan(z), rcond=None)
    return c.astype(np.float32)


ATAN_COEFFS = _fit_atan_coeffs(DEG)
_PI = float(np.float32(np.pi))

QW_DEG = 5  # quarter-wave polynomial degree in f^2


def _fit_quarter_wave() -> np.ndarray:
    """Least squares on Chebyshev nodes for sin(pi/2 f) (odd: coefficients
    of f * (f^2)^k) and cos(pi/2 f) (even: of (f^2)^k) on f in [0, 1];
    returns (2, QW_DEG+1) float32, row 0 sin, row 1 cos."""
    n = 2048
    f = (1 - np.cos(np.pi * (np.arange(n) + 0.5) / n)) / 2
    w = f * f
    As = np.stack([f * w**k for k in range(QW_DEG + 1)], axis=1)
    cs, *_ = np.linalg.lstsq(As, np.sin(np.pi / 2 * f), rcond=None)
    Ac = np.stack([w**k for k in range(QW_DEG + 1)], axis=1)
    cc, *_ = np.linalg.lstsq(Ac, np.cos(np.pi / 2 * f), rcond=None)
    return np.stack([cs, cc]).astype(np.float32)


SINCOS_COEFFS = _fit_quarter_wave()


def sin_cos_turns_plain(t: torch.Tensor):
    """The plain PyTorch version: (sin(2*pi*t), cos(2*pi*t)) of float32
    turns ``t`` (any range)."""
    t = t - torch.floor(t)
    u = t * 4.0
    q = torch.floor(u)
    f = u - q
    q = torch.where(q >= 4.0, q - 4.0, q)  # t rounded up to a whole turn
    w = f * f
    acc_s = torch.full_like(f, float(SINCOS_COEFFS[0, QW_DEG]))
    acc_c = torch.full_like(f, float(SINCOS_COEFFS[1, QW_DEG]))
    for k in range(QW_DEG - 1, -1, -1):
        acc_s = acc_s * w + float(SINCOS_COEFFS[0, k])
        acc_c = acc_c * w + float(SINCOS_COEFFS[1, k])
    s1 = acc_s * f
    c1 = acc_c
    # (sin, cos) by quadrant: 0 (s1, c1), 1 (c1, -s1), 2 (-s1, -c1), 3 (-c1, s1)
    q0, q1, q2 = q == 0.0, q == 1.0, q == 2.0
    sin = torch.where(q0, s1, torch.where(q1, c1, torch.where(q2, -s1, -c1)))
    cos = torch.where(q0, c1, torch.where(q1, -s1, torch.where(q2, -c1, s1)))
    return sin, cos


def atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: float32 elementwise atan2(y, x)."""
    ax, ay = x.abs(), y.abs()
    z = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-37)
    w = z * z
    acc = torch.full_like(z, float(ATAN_COEFFS[DEG]))
    for k in range(DEG - 1, -1, -1):
        acc = acc * w + float(ATAN_COEFFS[k])
    a = z * acc
    a = torch.where(ay > ax, _PI * 0.5 - a, a)
    a = torch.where(x < 0, _PI - a, a)
    a = torch.where(y < 0, -a, a)
    return torch.where((x == 0) & (y == 0), torch.zeros_like(a), a)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2(y, x): the plain version for CPU tensors, the CUDA
    device function (``atan2_launch``) for CUDA tensors."""
    if y.device.type == "cpu" and x.device.type == "cpu":
        return atan2_plain(y, x)
    _build.check_tensor(y, "y", device=y.device)
    _build.check_tensor(x, "x", device=y.device, shape=tuple(y.shape))
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = _build.lib().atan2_launch(
            y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(),
            ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "atan2_launch")
    atan2.launches += 1
    return out


atan2.launches = 0
