"""S4 ``iir_filter`` and S5 ``agc``: the DSP half's two linear recurrences
(reference: newsched_tpu/ops/iir.py ``_ar_scan``, its
``lax.associative_scan`` at ``:51`` and ``:74``, and
newsched_tpu/ops/agc.py ``agc``, its scan at ``:54``). Neither has a TPU
kernel: torch has no associative scan, so each is a CUDA kernel here
(``csrc/scan.cu``), one launch a call, a single-pass chained scan of
tiles of TILE samples taken from a ticket (the source's header).

Their plain versions stay beside the callers: ops/iir.py's chunk form
(``iir_filter_plain``) and ops/agc.py's doubling scan (``agc_plain``),
which serve CPU tensors. On a CUDA tensor ``iir_filter`` and ``agc``
launch these kernels or raise.

Host-side here: S4's constants (``scan_consts``: the feedback taps padded
to the instance's state width, and two tables of powers of the companion
matrix A, built in float64 and stored as float32: ``A^(SEG 2^k)`` for the
warps' scans and ``A^(TILE m)`` for the distances between tiles) and each
kernel's workspace (a ticket counter, never reset, whose count over a
launch's blocks is the launch's epoch, and a flag and an aggregate a tile
and a group of tiles, zeroed when made; a flag holds the epoch it was
published in). A caller that launches one workspace from two streams at
once races: each block instance keeps its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build

# csrc/scan.cu's kThreads, kSeg, kHalo, kMaxP, kPows, kGroup
THREADS = 256
SEG = 8                  # samples a thread
TILE = THREADS * SEG     # samples a tile (a block)
MAX_FF = 32              # feed-forward taps S4 applies itself
MAX_ORDER = 16           # the widest state (ROADMAP Queue 3, R3)
POWS = 6                 # A^(SEG 2^k), k < POWS: a warp's scan, warp to warp
GROUP = 64               # tiles a group: its last tile publishes its aggregate
ORDERS = (1, 2, 3, 4)    # instances of their own; 5-16 run MAX_ORDER


def state_width(order: int) -> int:
    """P, the instance of S4 that runs a feedback order: the order itself
    to 4 (0, the FIR alone, as 1 with a zero tap), MAX_ORDER past it.
    Raises past MAX_ORDER."""
    if order > MAX_ORDER:
        raise ValueError(
            f"iir_filter on the card takes feedback orders up to {MAX_ORDER} "
            f"(S4's widest state); got {order} (ROADMAP Queue 3, R3)")
    return max(order, 1) if order <= ORDERS[-1] else MAX_ORDER


def n_tiles(n: int) -> int:
    return -(-int(n) // TILE)


def n_slots(n: int) -> int:
    """Flags and aggregates a part of a batch of n: its tiles' and its
    groups'."""
    return n_tiles(n) + -(-n_tiles(n) // GROUP)


def companion(fb, P: int) -> np.ndarray:
    """A (P, P), float64: first row the feedback taps, zero past their
    order, the subdiagonal ones. z[n] = A z[n-1] + e0 v[n] with
    z = [y[n], ..., y[n-P+1]]."""
    fb = np.asarray(fb, np.float64)
    A = np.zeros((P, P))
    A[0, :len(fb)] = fb
    A[np.arange(1, P), np.arange(P - 1)] = 1.0
    return A


def powers_table(fb) -> np.ndarray:
    """pows[k] = A^(SEG 2^k), k < POWS, float64 (P, P) each, by repeated
    squaring: a warp's scan takes k < 5, warp to warp A^(32 SEG)."""
    A = companion(fb, state_width(len(fb)))
    pows = [np.linalg.matrix_power(A, SEG)]
    for _ in range(POWS - 1):
        pows.append(pows[-1] @ pows[-1])
    return np.stack(pows)


def distance_table(fb, n: int) -> np.ndarray:
    """dist[m] = A^(TILE m), m < n_tiles(n), float64 (P, P) each: tile j's
    aggregate reaches tile i's start through dist[i - 1 - j], the carried
    state through dist[i]."""
    P = state_width(len(fb))
    AT = np.linalg.matrix_power(companion(fb, P), TILE)
    dist = [np.eye(P)]
    for _ in range(n_tiles(n) - 1):
        dist.append(AT @ dist[-1])
    return np.stack(dist)


class ScanConsts(NamedTuple):
    """S4's constants and workspace for one filter on a device, batches of
    n samples (``scan_consts``)."""

    n: int
    order: int              # feedback order (y_hist's length)
    P: int                  # the instance (state_width)
    fir_outside: bool       # more than MAX_FF feed-forward taps: v comes in
    nff: int                # taps S4 applies (1, [1.0], where fir_outside)
    ff: torch.Tensor        # (nff,) float32
    fb: torch.Tensor        # (P,) float32, zero past the order
    pows: torch.Tensor      # (POWS, P, P) float32
    dist: torch.Tensor      # (n_tiles, P, P) float32
    tickets: torch.Tensor   # int64 (2,): the ticket counters, real, complex
    flags: torch.Tensor     # int32: a flag a slot, real (n_slots), complex
    vals: torch.Tensor      # float32: an aggregate (P) a flag


def scan_consts(ff_taps, fb_taps, n: int, device) -> ScanConsts:
    """S4's constants for real taps (host arrays) and batches of n, on a
    CUDA device; the workspace zeroed, a part for a real stream and one
    for a complex stream (two slots a tile and group). Raises past
    MAX_ORDER."""
    ff = np.asarray(ff_taps)
    fb = np.asarray(fb_taps)
    if np.iscomplexobj(ff) or np.iscomplexobj(fb):
        raise ValueError("iir_filter on the card takes real taps")
    if len(ff) < 1:
        raise ValueError("iir_filter needs at least one feed-forward tap")
    P = state_width(len(fb))
    outside = len(ff) > MAX_FF
    k_ff = np.ones(1) if outside else ff
    fbp = np.zeros(P)
    fbp[:len(fb)] = fb
    ns = n_slots(n)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return ScanConsts(
        n=int(n), order=len(fb), P=P, fir_outside=outside, nff=len(k_ff),
        ff=f32(k_ff), fb=f32(fbp), pows=f32(powers_table(fbp)),
        dist=f32(distance_table(fbp, n)),
        tickets=torch.zeros(2, dtype=torch.int64, device=device),
        flags=torch.zeros(3 * ns, dtype=torch.int32, device=device),
        vals=torch.zeros(3 * ns * P, dtype=torch.float32, device=device))


def _check_stream(t, name: str) -> None:
    if t.dtype not in (torch.float32, torch.complex64) or t.dim() != 1 \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, the kernel "
                         f"takes a contiguous float32 or complex64 vector")


def iir_scan(x: torch.Tensor, tail: torch.Tensor, y_hist: torch.Tensor,
             c: ScanConsts):
    """S4 on a CUDA tensor: x (n,) float32 or complex64 (the stream, or v
    where ``c.fir_outside``), tail its c.nff - 1 samples before, y_hist
    the last ``c.order`` outputs (y_hist[0] = y[-1]), both of x's dtype.
    Returns (y, new tail, new y_hist)."""
    if x.device.type != "cuda":
        raise ValueError(f"S4 runs on CUDA tensors (x on {x.device}); its "
                         f"plain version is ops/iir.py iir_filter_plain")
    n = int(x.shape[-1])
    if n != c.n:
        raise ValueError(f"S4's constants are built for batches of {c.n}, "
                         f"got {n}")
    if c.flags.device != x.device:
        raise ValueError(f"S4's constants are on {c.flags.device}, x on "
                         f"{x.device}")
    _check_stream(x, "x")
    for name, t, m in (("tail", tail, c.nff - 1), ("y_hist", y_hist, c.order)):
        if t.device != x.device or t.dtype != x.dtype \
                or tuple(t.shape) != (m,) or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, S4 takes contiguous {x.dtype} "
                             f"({m},) on {x.device}")
    lib = _build.lib()  # raises where the kernels cannot be built
    y = torch.empty_like(x)
    new_tail, new_hist = torch.empty_like(tail), torch.empty_like(y_hist)
    cs = 2 if x.is_complex() else 1
    part = (cs - 1) * n_slots(n)  # the complex stream's after the real's
    with torch.cuda.device(x.device):
        err = lib.iir_scan_launch(
            x.data_ptr(), y.data_ptr(), n, cs, tail.data_ptr(),
            new_tail.data_ptr(), c.ff.data_ptr(), c.nff, c.fb.data_ptr(),
            c.pows.data_ptr(), c.dist.data_ptr(), c.P, c.order,
            y_hist.data_ptr(), new_hist.data_ptr(),
            c.tickets[cs - 1:].data_ptr(), c.flags[part:].data_ptr(),
            c.vals[part * c.P:].data_ptr(), n_tiles(n),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "iir_scan_launch")
    iir_scan.launches += 1
    return y, new_tail, new_hist


iir_scan.launches = 0


class AgcWorkspace(NamedTuple):
    """S5's flags for batches of n samples on a device (``agc_workspace``)."""

    n: int
    tickets: torch.Tensor  # int64 (1,): the ticket counter
    flags: torch.Tensor    # int32: a flag a slot (a tile, a group)
    vals: torch.Tensor     # float32: a slot's aggregate (A, B)


def agc_workspace(n: int, device) -> AgcWorkspace:
    ns = n_slots(n)
    return AgcWorkspace(
        int(n), torch.zeros(1, dtype=torch.int64, device=device),
        torch.zeros(ns, dtype=torch.int32, device=device),
        torch.zeros(2 * ns, dtype=torch.float32, device=device))


def agc_scan(x: torch.Tensor, gain: torch.Tensor, rate, reference,
             max_gain: float = 0.0, workspace: AgcWorkspace | None = None):
    """S5 on a CUDA tensor: x (n,) complex64 or float32, gain the carried
    0-dim float32 gain on the card; rate and reference host numbers or
    0-dim float32 tensors on the card (read there by the kernel);
    max_gain <= 0 no clamp. ``workspace``: ``agc_workspace(n, x.device)``,
    made for this call when None. Returns (y, new gain)."""
    if x.device.type != "cuda":
        raise ValueError(f"S5 runs on CUDA tensors (x on {x.device}); its "
                         f"plain version is ops/agc.py agc_plain")
    n = int(x.shape[-1])
    _check_stream(x, "x")
    _build.device_scalar(gain, "gain", device=x.device, dtype=torch.float32)
    if workspace is None:
        workspace = agc_workspace(n, x.device)
    if workspace.n != n or workspace.flags.device != x.device:
        raise ValueError(f"S5's workspace is for {workspace.n} samples on "
                         f"{workspace.flags.device}, x has {n} on {x.device}")
    rate_ptr, rate_h = _build.scalar_arg(rate, "rate", x.device)
    ref_ptr, ref_h = _build.scalar_arg(reference, "reference", x.device)
    lib = _build.lib()  # raises where the kernels cannot be built
    y = torch.empty_like(x)
    g = torch.empty_like(gain)
    with torch.cuda.device(x.device):
        err = lib.agc_scan_launch(
            x.data_ptr(), y.data_ptr(), n, int(x.is_complex()),
            gain.data_ptr(), g.data_ptr(), rate_ptr, ref_ptr, rate_h, ref_h,
            float(np.float32(max_gain)), workspace.tickets.data_ptr(),
            workspace.flags.data_ptr(), workspace.vals.data_ptr(), n_tiles(n),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "agc_scan_launch")
    agc_scan.launches += 1
    return y, g


agc_scan.launches = 0
