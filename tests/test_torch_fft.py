"""The fused chain kernels' DFT as a 64-point FFT (csrc/fm_chain.cu, stage
2 of ``chain_tile``), held on the CPU: the 8 x 8 decomposition evaluated
in torch float32 with the twiddle table ``fm_chain_consts`` builds, in the
kernel's order of operations, each rounded on its own as the kernel's
``__fadd_rn``/``__fmul_rn`` are, against the plain versions' dense product
``acc @ planes_dft_matrix(64)`` and against numpy's float64 FFT with the
post-twiddle. Also: every ``FmChainConsts`` carries the table, and the
CUDA wrappers refuse constants without it (meta tensors stand in for the
card: the check comes before any launch).
"""

import numpy as np
import pytest
import torch

from newsched_tpu_torch.ops.cuda import fm_chain
from newsched_tpu_torch.probes import ablate

M = 64
R = 8  # M = R x R
# |FFT - exact| and |dense product - exact| over the row's largest exact
# output: FP32 rounding of a 64-point transform, a few ulp of the largest
# output (measured on the random rows: 2.5e-7 for the FFT, 5.7e-7 for the
# dense product)
REL_TOL = 1e-6


def _dft8(xr, xi, c):
    """kernel dft8 over the last axis: a = x[n] + x[n+4], b = (x[n] -
    x[n+4]) W8^n, then a 4-point DFT of each (even and odd outputs)."""
    ar = [xr[..., n] + xr[..., n + 4] for n in range(4)]
    ai = [xi[..., n] + xi[..., n + 4] for n in range(4)]
    br = [xr[..., n] - xr[..., n + 4] for n in range(4)]
    bi = [xi[..., n] - xi[..., n + 4] for n in range(4)]
    br[1], bi[1] = (br[1] + bi[1]) * c, (bi[1] - br[1]) * c
    br[2], bi[2] = bi[2], -br[2]
    br[3], bi[3] = (bi[3] - br[3]) * c, -((br[3] + bi[3]) * c)

    def dft4(yr, yi):
        s0r, s0i = yr[0] + yr[2], yi[0] + yi[2]
        d0r, d0i = yr[0] - yr[2], yi[0] - yi[2]
        s1r, s1i = yr[1] + yr[3], yi[1] + yi[3]
        d1r, d1i = yr[1] - yr[3], yi[1] - yi[3]
        return ([s0r + s1r, d0r + d1i, s0r - s1r, d0r - d1i],
                [s0i + s1i, d0i - d1r, s0i - s1i, d0i + d1r])

    (er, ei), (orr, oi) = dft4(ar, ai), dft4(br, bi)
    out_r = [v for k in range(4) for v in (er[k], orr[k])]
    out_i = [v for k in range(4) for v in (ei[k], oi[k])]
    return torch.stack(out_r, -1), torch.stack(out_i, -1)


def _cmul(re, im, cr, ci):
    return re * cr - im * ci, re * ci + im * cr


def fft_planes(acc: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Y = acc @ planes_dft_matrix(64) as the kernel computes it: thread n1
    of a row takes a[n1 + 8 n2], a radix-8 DFT over n2, times W64^(n1 k1),
    the exchange, a radix-8 DFT over n1, times the post-twiddle."""
    n = acc.shape[0]
    c = table[2, 8]  # cos(pi/4), the post-twiddle at j = 8
    # [row, n1, n2] = a[n1 + 8 n2]
    xr = acc[:, :M].reshape(n, R, R).transpose(1, 2)
    xi = acc[:, M:].reshape(n, R, R).transpose(1, 2)
    ar, ai = _dft8(xr, xi, c)  # [row, n1, k1]
    ar, ai = _cmul(ar, ai, table[0].reshape(R, R), table[1].reshape(R, R))
    xr, xi = _dft8(ar.transpose(1, 2), ai.transpose(1, 2), c)  # [row, k1, k2]
    post_r = table[2].reshape(R, R).T  # [k1, k2] = post[k1 + 8 k2]
    post_i = table[3].reshape(R, R).T
    yr, yi = _cmul(xr, xi, post_r, post_i)
    return torch.cat([yr.transpose(1, 2).reshape(n, M),
                      yi.transpose(1, 2).reshape(n, M)], dim=1)


def _exact(acc: np.ndarray) -> np.ndarray:
    """numpy's float64 FFT of a = re + i im, then the post-twiddle."""
    a = acc[:, :M].astype(np.float64) + 1j * acc[:, M:].astype(np.float64)
    y = np.fft.fft(a, axis=1) * np.exp(-2j * np.pi * np.arange(M) / M)
    return np.concatenate([y.real, y.imag], axis=1)


def _rows(case: str) -> np.ndarray:
    if case == "random":  # channel amplitudes about 8, as the FM band's
        rng = np.random.default_rng(9)
        return (rng.standard_normal((256, 2 * M)) * 8).astype(np.float32)
    if case == "impulse":  # 1 at every lane in turn, re lanes then im
        return np.eye(2 * M, dtype=np.float32)
    return np.zeros((4, 2 * M), np.float32)


@pytest.mark.parametrize("case", ["random", "impulse", "zero"])
def test_fft_with_the_table_is_the_planes_dft(case):
    acc = _rows(case)
    table = fm_chain.fm_chain_consts(np.ones((4, M), np.float32),
                                     np.ones(5, np.float32), "cpu").fft
    got = fft_planes(torch.from_numpy(acc), table).numpy()
    dense = (torch.from_numpy(acc)
             @ torch.from_numpy(fm_chain.planes_dft_matrix(M))).numpy()
    exact = _exact(acc)
    assert got.dtype == np.float32 and got.shape == acc.shape
    if case == "zero":
        assert not got.any() and not dense.any()
        return
    scale = np.abs(exact).max(axis=1, keepdims=True)
    err_fft = np.abs(got - exact) / scale
    err_dense = np.abs(got - dense) / scale
    assert err_fft.max() <= REL_TOL, err_fft.max()
    assert err_dense.max() <= 2 * REL_TOL, err_dense.max()
    if case == "impulse":  # one product per output: exact to a few ulp
        np.testing.assert_allclose(got, dense, rtol=0, atol=4e-7)


def test_fft_table_values():
    tab = fm_chain.planes_fft_table(M)
    assert tab.dtype == np.float32 and tab.shape == (4, M)
    n1, k1 = np.divmod(np.arange(M), R)
    inner = np.exp(-2j * np.pi * n1 * k1 / M).astype(np.complex64)
    post = np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)
    np.testing.assert_array_equal(tab[0] + 1j * tab[1], inner)
    np.testing.assert_array_equal(tab[2] + 1j * tab[3], post)
    assert tab[2, 8] == np.float32(np.sqrt(0.5))
    assert fm_chain.planes_fft_table(16).shape == (4, 16)
    assert fm_chain.planes_fft_table(48) is None  # no square decomposition


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_consts_carry_the_table_on_every_device(device):
    consts = fm_chain.fm_chain_consts(np.ones((16, M), np.float32),
                                      np.ones(65, np.float32), device)
    assert consts.fft.device.type == device
    assert consts.fft.dtype == torch.float32 and consts.fft.shape == (4, M)
    if device == "cpu":
        assert torch.equal(consts.fft,
                           torch.from_numpy(fm_chain.planes_fft_table(M)))


def _meta_case():
    L, A, decim, n = 16, 65, 8, 256
    consts = fm_chain.fm_chain_consts(np.ones((L, M), np.float32),
                                      np.ones(A, np.float32), "meta")
    z = dict(dtype=torch.float32, device="meta")
    st = (torch.zeros(16, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    return consts._replace(fft=None), torch.zeros(n, 2 * M, **z), st, decim


@pytest.mark.parametrize("kernel", ["K3", "K3p", "K5", "K6", "ablate"])
def test_cuda_wrappers_refuse_consts_without_the_table(kernel):
    consts, vb, (halo, prev, tail), decim = _meta_case()
    calls = {
        "K3": lambda: fm_chain.fm_chain_step_planes(
            vb, halo, prev, tail, consts, decim, 0.5),
        "K3p": lambda: fm_chain.fm_chain_step_planes(
            vb, halo, prev, tail, consts, decim, 0.5, pipelined=True),
        "K5": lambda: fm_chain.fm_chain_gen_step(
            0, 1.0, halo, prev, tail, consts, decim, 0.5, vb.shape[0]),
        "K6": lambda: fm_chain.fm_chain_gen_warm_step(
            0, 1.0, consts, decim, 0.5, vb.shape[0], warm=128),
        "ablate": lambda: ablate.fm_chain_ablate(vb, halo, prev, tail,
                                                 consts, decim, 0.5),
    }
    with pytest.raises(ValueError, match="twiddle table"):
        calls[kernel]()
