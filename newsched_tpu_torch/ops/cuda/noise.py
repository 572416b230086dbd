"""Position-pure Gaussian noise rows (reference:
newsched_tpu/ops/pallas/noise.py ``gaussian_rows``).

Determinism contract, as in the reference: rows are generated in 64-row
GROUPS, and a group's values depend only on ``(seed, absolute group
index)``. Any code that knows the absolute stream position can therefore
(re)produce any row span, tile boundaries and batch sizes notwithstanding
(batches must be multiples of 64 rows).

Generator: the TPU's hardware PRNG has no form off the TPU, so the port
uses a counter-based Philox4x32-10 (``csrc/philox.cuh``), keyed by the
seed, with counter (element index within the group, group lo, group hi,
0); the first ``draws`` (3, or 2) of its 4 words feed the reference's
Irwin-Hall N = 2*draws transform (sum of the uint16 halves, then
``(S - mean) * (1/std)``). Same contract and distribution as the TPU
stream (zero mean, unit variance; draws=3: support +-4.24 sigma, excess
kurtosis -0.2; draws=2: +-3.46 sigma, -0.3); DIFFERENT bits. ``draws`` is
part of the stream's identity, with the seed and the position.

The plain PyTorch version computes the same Philox in int64 arithmetic
masked to 32 bits (the 32x32->64 multiplies split into 16-bit halves, so
nothing overflows int64). The sum is an exact integer and the transform
is one subtract and one multiply in float32, so kernel and plain version
agree bit for bit on any device.

The reference carries the 64-bit group counter as two int32 halves (hi,
lo) with a uint32 wrap of lo into hi. The port's sources keep it as ONE
int64 tensor on the run's device, the same 64 bits in two's complement
(``group64``): the kernels read it from the card, so a captured step
replays with the position the step before left, and a step advances it
with one tensor add, which wraps at 2^64 as the pair does. A row may lie
before its base group (a sharded step reaches back into the rows before
its shard): its group is base + floor(row / 64), and with ``mask_pre`` a
group whose 64-bit index is negative as signed (before the stream's first
row) reads 0, as the reference's ``gen_rows(mask_pre=True)``. The host
pair arithmetic (``add_groups_signed``, ``advance_groups``) stays for the
hand-over from the reference and for tests.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build

GROUP_ROWS = 64
DRAWS = (2, 3)  # Philox words an element may take (Irwin-Hall N = 2*draws)

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


def _i64(g: int) -> int:
    """A host group index wrapped to the signed 64-bit range."""
    g &= (1 << 64) - 1
    return g - (1 << 64) if g >> 63 else g


def group_tensor(g, device) -> torch.Tensor:
    """The group counter as the sources keep it: a 0-dim int64 tensor on
    ``device`` (a host index is wrapped to 64 bits)."""
    if isinstance(g, torch.Tensor):
        return g.to(device=device, dtype=torch.int64)
    return torch.tensor(_i64(int(g)), dtype=torch.int64, device=device)


def advance(group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """The sources' per-batch counter update on the device: ``n_groups``
    on, wrapping at 2^64 (two's complement int64), no read-back."""
    return group + int(n_groups)


def add_groups_signed(hi: int, lo: int, off: int) -> tuple[int, int]:
    """64-bit group-counter add of a SIGNED offset as two int32 halves, in
    two's complement (reference ``noise.add_groups_signed``): a sharded step
    steps back from a shard's base group to the rows before it, which may
    cross zero on the first batch (hi goes negative: the pre-stream
    region)."""
    g = group64(hi, lo) + int(off)
    return _i32(g >> 32), _i32(g)


def advance_groups(hi: int, lo: int, n_groups: int) -> tuple[int, int]:
    """64-bit group-counter advance as two int32 halves (uint32 wraparound
    of lo carries into hi) — the source block's per-batch state update."""
    return add_groups_signed(hi, lo, n_groups)


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


def _check_draws(draws: int) -> int:
    if draws not in DRAWS:
        raise ValueError(f"draws {draws} not in {DRAWS}")
    return int(draws)


def stream_args(seed: int, draws: int) -> list:
    """The stream's constants as the kernels' launchers take them: key lo,
    key hi, draws, mean, 1/std (the position is read from the card)."""
    mean, std = _ih_const(_check_draws(draws))
    return [*_key(seed), int(draws), mean, 1.0 / std]


LAYOUTS = ("rows", "cf32")


def _counters(g0, n_rows: int, width: int, device, row0: int = 0):
    """The Philox counter of every element of rows [row0, row0 + n_rows):
    (c0, c1, c2, g), each (n_rows, width) int64: the element's index in its
    64-row group, its group's low and high words, and the group (64-bit,
    two's complement)."""
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64,
                        device=device)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    grp = torch.div(rows, GROUP_ROWS, rounding_mode="floor")
    g = group_tensor(g0, device) + grp
    c0 = (rows - grp * GROUP_ROWS) * width + cols
    c1 = (g & _M32).expand(n_rows, width)
    c2 = ((g >> 32) & _M32).expand(n_rows, width)
    return c0, c1, c2, g.expand(n_rows, width)


def _check_layout(layout: str, width: int) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if layout == "cf32" and width % 2:
        raise ValueError(f"layout 'cf32' pairs the halves of a row: width "
                         f"{width} is odd")


def gaussian_rows_plain(g0, *, n_rows: int, width: int, seed: int, device,
                        draws: int = 3, mask_pre: bool = False,
                        row0: int = 0, amp=None,
                        layout: str = "rows") -> torch.Tensor:
    """The plain PyTorch version of ``gaussian_rows``, for the rows
    [row0, row0 + n_rows) counted from the first row of group ``g0`` (the
    64-bit index: an int64 tensor or a host int); row0 may be negative and
    n_rows need not fill whole groups (the row loader of the generating
    kernels, csrc/philox.cuh ``gauss``). ``amp`` and ``layout`` as
    ``gaussian_rows``: a float32 multiply and the complex build after the
    draw."""
    mean, std = _ih_const(_check_draws(draws))
    _check_layout(layout, width)
    c0, c1, c2, g = _counters(g0, n_rows, width, device, row0)
    words = _philox4x32_10(c0, c1, c2, torch.zeros_like(c0), *_key(seed))
    s = sum((w & 0xFFFF) + (w >> 16) for w in words[:draws])
    f32 = dict(dtype=torch.float32, device=device)
    out = (s.to(torch.float32) - torch.tensor(mean, **f32)) \
        * torch.tensor(1.0 / std, **f32)
    if mask_pre:
        out = torch.where(g < 0, torch.zeros((), **f32), out)
    if amp is not None:
        amp = torch.as_tensor(amp, **f32)
    if layout == "cf32":  # the noise blocks' own expressions
        h = width // 2
        re, im = out[:, :h].reshape(-1), out[:, h:].reshape(-1)
        return torch.complex(re, im) if amp is None else \
            torch.complex(re * amp, im * amp)
    return out if amp is None else out * amp


def launch_shape(width: int, layout: str = "rows") -> tuple[int, int, int,
                                                           int]:
    """(vec, units, bx, ry) of K4's 2-D launch: a thread writes vec lanes
    (4, one 16-byte store, where the row allows it; in the cf32 layout vec
    lanes of each half, two stores) of ``units`` a row; bx threads across
    them (at most 16, each taking every bx-th unit: 8 elements a thread at
    the flagship's width, over which its round keys and group words are
    spent); ry rows a block, the largest power of 2 dividing 64 with bx *
    ry <= 256, so a block's rows lie in one 64-row group. At width 128:
    (4, 32, 16, 16), and in cf32 (4, 16, 16, 16)."""
    lanes = width // 2 if layout == "cf32" else width
    vec = 4 if lanes % 4 == 0 else 1
    units = lanes // vec
    bx = min(units, 16)
    ry = 1
    while ry < GROUP_ROWS and bx * ry * 2 <= 256:
        ry *= 2
    return vec, units, bx, ry


def gaussian_rows(g0, *, n_rows: int, width: int, seed: int, device,
                  draws: int = 3, mask_pre: bool = False, amp=None,
                  layout: str = "rows") -> torch.Tensor:
    """(n_rows, width) f32 standard-normal rows for the absolute row span
    starting at group ``g0``, the 64-row group index (a 0-dim int64 tensor
    on the device, the sources' counter, which the kernel reads from the
    card; or a host int), from ``draws`` Philox words per element (3 or 2).
    ``mask_pre``: groups before the stream (negative as signed 64-bit) read
    0.

    ``amp``: None, or the amplitude (the noise blocks' float32 parameter
    tensor on the device, which the kernel reads from the card; or a
    number): each element times it, the product ``r * amp`` rounds.
    ``layout``: "rows", or "cf32", the (n_rows * width/2,) complex64 stream
    ``torch.complex(r[:, :w/2].reshape(-1), r[:, w/2:].reshape(-1))`` (times
    amp) that ``analog.noise_source`` emits.

    On a CPU device this is the plain version; on a CUDA device it
    launches ``gaussian_rows_launch`` (csrc/noise.cu, K4)."""
    if n_rows % GROUP_ROWS:
        raise ValueError(f"n_rows {n_rows} not a multiple of {GROUP_ROWS}")
    _check_layout(layout, width)
    device = torch.device(device)
    if device.type == "cpu":
        return gaussian_rows_plain(g0, n_rows=n_rows, width=width, seed=seed,
                                   device=device, draws=draws,
                                   mask_pre=mask_pre, amp=amp, layout=layout)
    if device.type != "cuda":
        raise ValueError(f"gaussian_rows runs on cpu or cuda, not {device}")
    args = stream_args(seed, draws)
    cplx = layout == "cf32"
    shape = (n_rows * width // 2, 2) if cplx else (n_rows, width)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    device = out.device  # "cuda" -> the current card, "cuda:0"
    g = device_group(g0, device)
    a = (None if amp is None else
         _build.device_scalar(amp, "amp", device=device, dtype=torch.float32))
    vec, _, bx, ry = launch_shape(width, layout)
    with torch.cuda.device(device):
        err = _build.lib().gaussian_rows_launch(
            out.data_ptr(), n_rows, width, g.data_ptr(), *args,
            int(bool(mask_pre)), None if a is None else a.data_ptr(),
            int(cplx), vec, bx, ry,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "gaussian_rows_launch")
    gaussian_rows.launches += 1
    return torch.view_as_complex(out) if cplx else out


gaussian_rows.launches = 0


def device_group(g0, device) -> torch.Tensor:
    """The group counter as a kernel reads it: the sources' int64 tensor on
    ``device``, or a host index uploaded for the launch (keep the tensor
    alive until the launch)."""
    if not isinstance(g0, torch.Tensor):
        g0 = _i64(int(g0))
    return _build.device_scalar(g0, "group", device=device, dtype=torch.int64)
