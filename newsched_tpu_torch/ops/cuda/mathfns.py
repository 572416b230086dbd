"""atan2 as the fused chain computes it (reference:
newsched_tpu/ops/pallas/mathfns.py ``atan2``, deg=9).

The CUDA form is a ``__device__`` function inside ``csrc/fm_chain.cu``;
``atan2`` here launches it over a whole tensor, so the card can check it
against the plain version on its own:

    z = min(|x|,|y|) / max(|x|,|y|)          z in [0, 1]
    a = atan(z)      via odd polynomial in z
    a = pi/2 - a     if |y| > |x|
    a = pi  - a      if x < 0
    a = -a           if y < 0
    a = 0            if x == y == 0 (either sign of zero)

The coefficients are the reference's least-squares fit on Chebyshev nodes
(float64, then cast), degree 9 in z^2: < 1e-7 max error on [0, 1].
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
