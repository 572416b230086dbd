"""The planes DFT as the kernels compute it: a radix-P step and P 64-point
FFTs of 8 x 8 for M = 64 P channels, P = 1 .. 16 (``csrc/planes_fft.cuh``,
taken by the fused chains K3, K5, K6 at every P, K3p and the ablation at
P = 1, and by the channelizer front end K1 at every P). Past P = 7 the
radix-P step is two passes, P = P1 x P2 (``plan``): the prime-factor map
where the factors are coprime, twiddles where they are not, one pass at
P = 8, 11 and 13.

``planes_fft_table`` is the kernels' twiddle table; ``fft_planes`` repeats
the kernels' arithmetic in torch float32, every operation rounded on its
own as the kernels' ``__fadd_rn``/``__fmul_rn`` are, so that on the same
rows it gives their bits (what the CPU tests and chip_smoke.py hold the
kernels to).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

CHANNELS = tuple(64 * P for P in range(1, 17))  # M = 64 P, P = 1 .. 16
# P = P1 x P2 of the radix-P step past P = 7 (csrc/planes_fft.cuh plan_of):
# one pass at 8 (dft8), 11 and 13 (the pairs' form); 9 and 16 with
# twiddles; 10, 12, 14 and 15 by the prime-factor map
FACTORS = {8: (8, 1), 9: (3, 3), 10: (2, 5), 11: (11, 1), 12: (4, 3),
           13: (13, 1), 14: (2, 7), 15: (3, 5), 16: (4, 4)}


def planes_fft_table(M: int) -> np.ndarray | None:
    """(4, M) float32 twiddles of the planes DFT taken as a radix-P step and
    P 64-point FFTs of 8 x 8 (M = 64 P), or None where M is not in
    ``CHANNELS``: row 0/1 the real/imaginary parts of
    e^{-2 pi i n1 k1 / 64} at n1 * 8 + k1 (n1, k1 < 8), zeros past 64;
    row 2/3 those of e^{-2 pi i j / M} at j < M (the post-twiddle, and the
    radix-P step's W_M^(n r) at j = n r, and at P >= 5 the P-point DFT's
    cos and sin of 2 pi a / P at j = 64 a). Computed in float64, then
    cast."""
    if M not in CHANNELS:
        return None
    n1, k1 = np.divmod(np.arange(64), 8)
    inner = np.zeros(M, np.complex128)
    inner[:64] = np.exp(-2j * np.pi * n1 * k1 / 64)
    post = np.exp(-2j * np.pi * np.arange(M) / M)
    return np.stack([inner.real, inner.imag, post.real,
                     post.imag]).astype(np.float32)


def _dft8(xr, xi, c):
    """The kernels' dft8 over the last axis (``_dft8_lists``)."""
    out_r, out_i = _dft8_lists([xr[..., n] for n in range(8)],
                               [xi[..., n] for n in range(8)], c)
    return torch.stack(out_r, -1), torch.stack(out_i, -1)


def _dft8_lists(xr: list, xi: list, c):
    """The kernels' dft8 of the lists' 8 entries: a = x[n] + x[n+4], b =
    (x[n] - x[n+4]) W8^n, then a 4-point DFT of each (even and odd
    outputs)."""
    ar = [xr[n] + xr[n + 4] for n in range(4)]
    ai = [xi[n] + xi[n + 4] for n in range(4)]
    br = [xr[n] - xr[n + 4] for n in range(4)]
    bi = [xi[n] - xi[n + 4] for n in range(4)]
    br[1], bi[1] = (br[1] + bi[1]) * c, (bi[1] - br[1]) * c
    br[2], bi[2] = bi[2], -br[2]
    br[3], bi[3] = (bi[3] - br[3]) * c, -((br[3] + bi[3]) * c)
    (er, ei), (orr, oi) = _dft4(ar, ai), _dft4(br, bi)
    return ([v for k in range(4) for v in (er[k], orr[k])],
            [v for k in range(4) for v in (ei[k], oi[k])])


def _dft4(yr, yi):
    s0r, s0i = yr[0] + yr[2], yi[0] + yi[2]
    d0r, d0i = yr[0] - yr[2], yi[0] - yi[2]
    s1r, s1i = yr[1] + yr[3], yi[1] + yi[3]
    d1r, d1i = yr[1] - yr[3], yi[1] - yi[3]
    return ([s0r + s1r, d0r + d1i, s0r - s1r, d0r - d1i],
            [s0i + s1i, d0i - d1r, s0i - s1i, d0i + d1r])


def _dftp(xr: list, xi: list, h, cs=None, sn=None):
    """The kernels' dftp (P <= 4) and dftp_wide (P = 6, and the odd P >= 5
    from the pairs: ``cs``, ``sn`` the cos and sin of 2 pi a / P): the
    P-point DFT of the lists' entries."""
    P = len(xr)
    if P == 6:  # 2 x 3, the prime-factor map: y at (3 k1 + 4 k2) % 6
        (ar, ai), (br, bi) = (_dftp([xr[0], xr[2], xr[4]], [xi[0], xi[2], xi[4]], h),
                              _dftp([xr[3], xr[5], xr[1]], [xi[3], xi[5], xi[1]], h))
        yr, yi = [None] * 6, [None] * 6
        for k2 in range(3):
            lo, hi = 4 * k2 % 6, (3 + 4 * k2) % 6
            yr[lo], yi[lo] = ar[k2] + br[k2], ai[k2] + bi[k2]
            yr[hi], yi[hi] = ar[k2] - br[k2], ai[k2] - bi[k2]
        return yr, yi
    if P % 2 and P >= 5:  # from the pairs x[m] +- x[P - m]
        H = (P - 1) // 2
        sr = [None] + [xr[m] + xr[P - m] for m in range(1, H + 1)]
        si = [None] + [xi[m] + xi[P - m] for m in range(1, H + 1)]
        dr = [None] + [xr[m] - xr[P - m] for m in range(1, H + 1)]
        di = [None] + [xi[m] - xi[P - m] for m in range(1, H + 1)]
        yr, yi = [xr[0]] + [None] * (P - 1), [xi[0]] + [None] * (P - 1)
        for m in range(1, H + 1):
            yr[0], yi[0] = yr[0] + sr[m], yi[0] + si[m]
        for k in range(1, H + 1):
            tr, ti = xr[0], xi[0]
            for m in range(1, H + 1):
                a = m * k % P
                tr, ti = tr + cs[a] * sr[m], ti + cs[a] * si[m]
                pr, pi = sn[a] * dr[m], sn[a] * di[m]
                ur, ui = (pr, pi) if m == 1 else (ur + pr, ui + pi)
            yr[k], yi[k] = tr + ui, ti - ur
            yr[P - k], yi[P - k] = tr - ui, ti + ur
        return yr, yi
    if P == 2:
        return [xr[0] + xr[1], xr[0] - xr[1]], [xi[0] + xi[1], xi[0] - xi[1]]
    if P == 3:
        sr, si = xr[1] + xr[2], xi[1] + xi[2]
        dr, di = xr[1] - xr[2], xi[1] - xi[2]
        tr, ti = xr[0] - 0.5 * sr, xi[0] - 0.5 * si
        hr, hi = h * dr, h * di
        return [xr[0] + sr, tr + hi, tr - hi], [xi[0] + si, ti - hr, ti + hr]
    return _dft4(xr, xi)


def _cmul(re, im, cr, ci):
    return re * cr - im * ci, re * ci + im * cr


class Plan(NamedTuple):
    """The radix-P step past P = 7 as two passes, P = P1 x P2 (csrc
    planes_fft.cuh ``Plan``): pass 1 the P1-point DFTs, pass 2 the
    P2-point DFTs (none at P2 = 1); ``pfa``: the prime-factor map (P1, P2
    coprime, no twiddles between the passes), whose outputs q = (e1 k1 +
    e2 k2) mod P; else q = k1 + P1 k2 and the twiddles W_P^(j2 k1)."""

    P: int
    P1: int
    P2: int
    pfa: bool
    e1: int
    e2: int


def plan(P: int) -> Plan:
    """The two passes' plan at P = 8 .. 16 (``FACTORS``)."""
    P1, P2 = FACTORS[P]
    pfa = P2 > 1 and math.gcd(P1, P2) == 1
    return Plan(P, P1, P2, pfa,
                P2 * pow(P2, -1, P1) % P if pfa else 0,
                P1 * pow(P1, -1, P2) % P if pfa else 0)


def _slot(pl: Plan, a: int, b: int) -> int:
    """The 64-lane part of a row that holds the passes' value (a, b): the
    input j = slot(j1, j2), pass 1's (k1, j2) and pass 2's (k1, k2)."""
    return (pl.P2 * a + pl.P1 * b) % pl.P if pl.pfa else pl.P2 * a + b


def _out(pl: Plan, k1: int, k2: int) -> int:
    """The radix step's output q that pass 2 leaves at slot(k1, k2)."""
    return (pl.e1 * k1 + pl.e2 * k2) % pl.P if pl.pfa else k1 + pl.P1 * k2


def slot_of(P: int, q: int) -> int:
    """The 64-lane part of a row in which sub-FFT q runs and leaves its
    outputs j = P (t + 8 k2) + q (the part q at P <= 7)."""
    if P < 8:
        return q
    pl = plan(P)
    return _slot(pl, q % pl.P1, q % pl.P2 if pl.pfa else q // pl.P1)


def _dft_f(F: int, xr: list, xi: list, table: torch.Tensor, h, c):
    """An F-point DFT of the two passes (F = 2, 3, 4, 5, 7, 8, 11, 13),
    its cos and sin of 2 pi a / F the table's post-twiddle at j = a M/F."""
    if F == 8:
        return _dft8_lists(xr, xi, c)
    step = table.shape[1] // F
    return _dftp(xr, xi, h, table[2, ::step], -table[3, ::step])


def _radix_two_pass(xr, xi, table: torch.Tensor, h, c):
    """The radix-P step at P >= 8 on [row, j, n1, n2] planes values, in
    the kernels' two passes: pass 1 at each j2 the P1-point DFT of the
    parts slot(j1, j2), left at slot(k1, j2); pass 2 at each k1 the
    twiddles W_P^(j2 k1) (not by the prime-factor map; none where j2 k1 =
    0), the P2-point DFT, and the radix twiddles W_M^(n q) of its outputs
    q > 0, left at slot(k1, k2) (at P2 = 1 pass 1 takes those twiddles and
    pass 2 is none). Returns the lists over q of sub-FFT q's input."""
    P = xr.shape[1]
    pl = plan(P)
    nn = torch.arange(64, device=xr.device).reshape(8, 8).T  # [n1, n2]
    pr, pi = [xr[:, j] for j in range(P)], [xi[:, j] for j in range(P)]

    def radix(yr, yi, q):
        return _cmul(yr, yi, table[2][nn * q], table[3][nn * q])

    for b in range(pl.P2):
        idx = [_slot(pl, a, b) for a in range(pl.P1)]
        yr, yi = _dft_f(pl.P1, [pr[i] for i in idx], [pi[i] for i in idx],
                        table, h, c)
        for k1, i in enumerate(idx):
            pr[i], pi[i] = (radix(yr[k1], yi[k1], k1)
                            if pl.P2 == 1 and k1 > 0 else (yr[k1], yi[k1]))
    for k1 in range(pl.P1 if pl.P2 > 1 else 0):
        idx = [_slot(pl, k1, b) for b in range(pl.P2)]
        yr, yi = [pr[i] for i in idx], [pi[i] for i in idx]
        for b in range(1, pl.P2):
            if not pl.pfa and k1 > 0:
                m = 64 * b * k1
                yr[b], yi[b] = _cmul(yr[b], yi[b], table[2, m], table[3, m])
        yr, yi = _dft_f(pl.P2, yr, yi, table, h, c)
        for k2, i in enumerate(idx):
            q = _out(pl, k1, k2)
            pr[i], pi[i] = radix(yr[k2], yi[k2], q) if q else (yr[k2], yi[k2])
    parts = [slot_of(P, q) for q in range(P)]
    return [pr[s] for s in parts], [pi[s] for s in parts]


def fft_planes(acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Y = acc @ planes_dft_matrix(M) on (n, 2M) float32 planes rows as the
    kernels compute it, with their table (``planes_fft_table(M)``): thread
    t of a row holds a[t + 8 n2 + 64 j], the radix-P DFT over j times
    W_M^((t + 8 n2) r), then for each r a radix-8 DFT over n2, times
    W64^(t k1), the exchange, a radix-8 DFT over n1, times the
    post-twiddle of output P (k1 + 8 k2) + r; past P = 7 the radix-P step
    is ``_radix_two_pass``. Where a kernel leaves each output in shared
    memory (P >= 5: ``wide_lane``; P >= 8: its part ``slot_of``) does not
    change its value."""
    n, W = acc.shape
    M = W // 2
    P = M // 64
    c = table[2, M // 8]  # cos(pi/4)
    h = -table[3, M // 3]  # sin(pi/3), read at P = 3 and 6
    cs, sn = table[2, ::64], -table[3, ::64]  # cos, sin of 2 pi a/P, P >= 5
    # [row, j, n1, n2] = a[n1 + 8 n2 + 64 j]
    xr = acc[:, :M].reshape(n, P, 8, 8).transpose(2, 3)
    xi = acc[:, M:].reshape(n, P, 8, 8).transpose(2, 3)
    if P >= 8:
        yr, yi = _radix_two_pass(xr, xi, table, h, c)
        xr, xi = torch.stack(yr, 1), torch.stack(yi, 1)
    elif P > 1:
        yr, yi = _dftp([xr[:, j] for j in range(P)],
                       [xi[:, j] for j in range(P)], h, cs, sn)
        nn = torch.arange(64, device=acc.device).reshape(8, 8).T  # [n1, n2]
        for q in range(1, P):
            m = nn * q
            yr[q], yi[q] = _cmul(yr[q], yi[q], table[2][m], table[3][m])
        xr, xi = torch.stack(yr, 1), torch.stack(yi, 1)
    ar, ai = _dft8(xr, xi, c)  # [row, r, n1, k1]
    ar, ai = _cmul(ar, ai, table[0, :64].reshape(8, 8),
                   table[1, :64].reshape(8, 8))
    # [row, r, k1, k2]
    xr, xi = _dft8(ar.transpose(2, 3), ai.transpose(2, 3), c)
    # [row, k2, k1, r], output j = r + P k1 + 8 P k2
    xr, xi = xr.permute(0, 3, 2, 1), xi.permute(0, 3, 2, 1)
    yr, yi = _cmul(xr, xi, table[2].reshape(8, 8, P),
                   table[3].reshape(8, 8, P))
    return torch.cat([yr.reshape(n, M), yi.reshape(n, M)], dim=1)
