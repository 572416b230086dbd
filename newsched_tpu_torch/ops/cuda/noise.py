"""Position-pure Gaussian noise rows (reference:
newsched_tpu/ops/pallas/noise.py ``gaussian_rows``).

Determinism contract, as in the reference: rows are generated in 64-row
GROUPS, and a group's values depend only on ``(seed, absolute group
index)``. Any code that knows the absolute stream position can therefore
(re)produce any row span, tile boundaries and batch sizes notwithstanding
(batches must be multiples of 64 rows).

Generator: the TPU's hardware PRNG has no form off the TPU, so the port
uses a counter-based Philox4x32-10 (``csrc/noise.cu``), keyed by the seed,
with counter (element index within the group, group lo, group hi, 0); the
first 3 of its 4 words feed the reference's Irwin-Hall N=6 transform (sum
of the six uint16 halves, then ``(S - mean) * (1/std)``). Same contract
and distribution as the TPU stream (zero mean, unit variance, support
+-4.24 sigma, excess kurtosis -0.2); DIFFERENT bits.

The plain PyTorch version computes the same Philox in int64 arithmetic
masked to 32 bits (the 32x32->64 multiplies split into 16-bit halves, so
nothing overflows int64). The sum is an exact integer and the transform
is one subtract and one multiply in float32, so kernel and plain version
agree bit for bit on any device.

The 64-bit group counter is carried as two int32 halves (hi, lo) with the
reference's uint32 wrap of lo into hi; here they are host ints, since the
stream position of every batch is known before it is generated.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build

GROUP_ROWS = 64
DRAWS = 3  # Philox words per element (Irwin-Hall N = 2 * DRAWS)

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _ih_const(draws: int):
    """Irwin-Hall N=2*draws over uint16 halves: mean N*(2^16-1)/2,
    var N*(2^32-1)/12."""
    n = 2 * draws
    return n * 65535.0 / 2.0, float(np.sqrt(n * (65536.0 ** 2 - 1) / 12.0))


def _i32(u: int) -> int:
    """uint32 bit pattern -> the int32 it reads as."""
    u &= _M32
    return u - (1 << 32) if u >> 31 else u


def group64(hi: int, lo: int) -> int:
    """(hi, lo) int32 halves -> the 64-bit group index (two's complement)."""
    return (int(hi) << 32) | (int(lo) & _M32)


def advance_groups(hi: int, lo: int, n_groups: int) -> tuple[int, int]:
    """64-bit group-counter advance as two int32 halves (uint32 wraparound
    of lo carries into hi) — the source block's per-batch state update."""
    g = group64(hi, lo) + int(n_groups)
    return _i32(g >> 32), _i32(g)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for x in [0, 2^32), in int64 without
    overflow: x = xh * 2^16 + xl, so each partial product is < 2^48."""
    a = (x & 0xFFFF) * m
    b = (x >> 16) * m
    lo = (a + ((b & 0xFFFF) << 16)) & _M32
    hi = ((a >> 16) + b) >> 16
    return hi, lo


def _philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed: int) -> tuple[int, int]:
    return int(seed) & _M32, (int(seed) >> 32) & _M32


def gaussian_rows_plain(g0_hi: int, g0_lo: int, *, n_rows: int, width: int,
                        seed: int, device) -> torch.Tensor:
    """The plain PyTorch version of ``gaussian_rows``."""
    mean, std = _ih_const(DRAWS)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    g = group64(g0_hi, g0_lo) + rows // GROUP_ROWS
    c0 = (rows % GROUP_ROWS) * width + cols
    c1 = (g & _M32).expand(n_rows, width)
    c2 = ((g >> 32) & _M32).expand(n_rows, width)
    c3 = torch.zeros_like(c0)
    words = _philox4x32_10(c0, c1, c2, c3, *_key(seed))
    s = sum((w & 0xFFFF) + (w >> 16) for w in words[:DRAWS])
    f32 = dict(dtype=torch.float32, device=device)
    return (s.to(torch.float32) - torch.tensor(mean, **f32)) \
        * torch.tensor(1.0 / std, **f32)


def gaussian_rows(g0_hi: int, g0_lo: int, *, n_rows: int, width: int,
                  seed: int, device) -> torch.Tensor:
    """(n_rows, width) f32 standard-normal rows for the absolute row span
    starting at group G = (g0_hi, g0_lo), the 64-row group index as two
    int32 halves. Scale by amplitude outside.

    On a CPU device this is the plain version; on a CUDA device it
    launches ``gaussian_rows_launch`` (csrc/noise.cu)."""
    if n_rows % GROUP_ROWS:
        raise ValueError(f"n_rows {n_rows} not a multiple of {GROUP_ROWS}")
    device = torch.device(device)
    if device.type == "cpu":
        return gaussian_rows_plain(g0_hi, g0_lo, n_rows=n_rows, width=width,
                                   seed=seed, device=device)
    if device.type != "cuda":
        raise ValueError(f"gaussian_rows runs on cpu or cuda, not {device}")
    mean, std = _ih_const(DRAWS)
    out = torch.empty((n_rows, width), dtype=torch.float32, device=device)
    g = group64(g0_hi, g0_lo)
    k0, k1 = _key(seed)
    with torch.cuda.device(device):
        err = _build.lib().gaussian_rows_launch(
            out.data_ptr(), n_rows, width, g & _M32, (g >> 32) & _M32, k0, k1,
            mean, 1.0 / std, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "gaussian_rows_launch")
    gaussian_rows.launches += 1
    return out


gaussian_rows.launches = 0
