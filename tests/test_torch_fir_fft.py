"""The live FIR kernel K9 as an overlap-save FFT convolution
(csrc/fir_source.cu), held on the CPU: the kernel's blocks, windows and
transforms evaluated in torch float32 with the table ``fir_tone_consts``
builds, in the kernel's order of operations, each rounded on its own as the
kernel's ``__fadd_rn``/``__fmul_rn`` are. Against the plain version (the
direct form) and a float64 convolution of the same samples; bit for bit
across tiles, segment groups, a batch split and a time shard; at an R that
L does not divide. Also: the table's values, the radix and geometry
picks, and the CUDA wrapper's refusal of constants without the table
(meta tensors stand in for the card: the check comes before any launch).
"""

import numpy as np
import pytest
import torch

from newsched_tpu_torch.ops import firdes, nco
from newsched_tpu_torch.ops.cuda import fir_source
from newsched_tpu_torch.ops.cuda.sources import (folded_index, folded_values,
                                                 mask_before_stream,
                                                 shard_phase)

FS, FREQ, NTAPS, S = 1e6, 123_456.0, 128, 64
DP = nco.freq_to_dphase(FREQ, FS)
# |FFT form - float64| and |FFT form - plain| over max|out|: FP32 rounding
# of two 256-point transforms and the spectrum product, a few ulp of the
# largest value a transform holds (measured at 128 taps: the FFT form
# 3.9e-7 from float64, the direct form's 128-term sums 6.5e-7, the two
# 8.2e-7 apart)
REL_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(ntaps=NTAPS):
    return firdes.low_pass(1.0, FS, 0.2 * FS, 0.05 * FS,
                           ntaps=ntaps).astype(np.float32)


def _twiddle(br, bi, n, S_, wr, wi, Q):
    """The kernel's b[n] *= W_S^n (dft's special cases)."""
    c = wr[Q // 8]
    if 4 * n == S_:
        return bi, -br
    if 8 * n == S_:
        return (br + bi) * c, (bi - br) * c
    if 8 * n == 3 * S_:
        return (bi - br) * c, -((br + bi) * c)
    m = n * (Q // S_)
    return br * wr[m] - bi * wi[m], br * wi[m] + bi * wr[m]


def _dft(xr, xi, wr, wi, Q):
    """The kernel's dft<S, Q> over the last axis (decimation in frequency,
    natural order in and out)."""
    S_ = xr.shape[-1]
    if S_ == 2:
        return (torch.stack([xr[..., 0] + xr[..., 1], xr[..., 0] - xr[..., 1]], -1),
                torch.stack([xi[..., 0] + xi[..., 1], xi[..., 0] - xi[..., 1]], -1))
    H = S_ // 2
    ar, ai = xr[..., :H] + xr[..., H:], xi[..., :H] + xi[..., H:]
    br, bi = xr[..., :H] - xr[..., H:], xi[..., :H] - xi[..., H:]
    cols = [(br[..., 0], bi[..., 0])] + [
        _twiddle(br[..., n], bi[..., n], n, S_, wr, wi, Q) for n in range(1, H)]
    br = torch.stack([c[0] for c in cols], -1)
    bi = torch.stack([c[1] for c in cols], -1)
    ar, ai = _dft(ar, ai, wr, wi, Q)
    br, bi = _dft(br, bi, wr, wi, Q)
    return (torch.stack([ar, br], -1).flatten(-2),
            torch.stack([ai, bi], -1).flatten(-2))


def _cmul(re, im, cr, ci):
    return re * cr - im * ci, re * ci + im * cr


def _fft(xr, xi, tab, Q):
    """The kernel's fft<Q>: (B, t, n) = x[t + Q n] in, (B, t, k) = X[t + Q k]
    out: a radix-Q DFT over n, times W_N^(t k), the exchange, a radix-Q DFT
    over the threads."""
    N = Q * Q
    wr, wi = tab[0, :N // 2:Q], tab[1, :N // 2:Q]  # W_Q^m = W_N^(m Q)
    ar, ai = _dft(xr, xi, wr, wi, Q)  # [B, t, k1]
    tk = torch.arange(Q)[:, None] * torch.arange(Q)[None, :]
    wtr, wti = tab[0, tk], tab[1, tk]
    ar2, ai2 = _cmul(ar[..., 1:], ai[..., 1:], wtr[:, 1:], wti[:, 1:])
    ar = torch.cat([ar[..., :1], ar2], -1)
    ai = torch.cat([ai[..., :1], ai2], -1)
    return _dft(ar.transpose(-1, -2), ai.transpose(-1, -2), wr, wi, Q)


def fir_fft_model(ph0, dp, amp, first, taps, D, R, tile=None,
                  seg_group=fir_source.SEG_GROUP, shard=0):
    """K9 as the kernel computes it, block by block: each block's window
    generated from the phase, its transforms (slot i: segment i % GS, the
    (i // GS)-th transform touching the tile), their kept outputs written
    to the block's own rows only. Rows no block writes stay NaN."""
    consts = fir_source.fir_tone_consts(taps, "cpu")
    g = fir_source._geometry(R, D, len(taps), tile, seg_group)
    Q, T, GS = g.Q, g.T, g.GS
    N, L = Q * Q, Q * Q // 2
    tab = consts.fft
    out = torch.full((R // D, 2 * S), float("nan"))
    ph = shard_phase(ph0, dp, shard, R)
    for r0 in range(0, R, T):
        idx = folded_index(R, r0 - g.off, g.WR, "cpu")
        win = mask_before_stream(folded_values(ph, dp, amp, idx), idx, first,
                                 shard)
        for s0 in range(0, S, GS):
            xs, where = [], []
            for i in range(GS * g.NQ):
                sl, iq = i % GS, i // GS
                js = (shard * S + s0 + sl) * R + r0
                q = js // L + iq
                if q > (js + T - 1) // L:
                    continue
                base = q * L - L - js + g.off
                col = win[base:base + N]
                xs.append(torch.stack([col[:, s0 + sl], col[:, S + s0 + sl]]))
                where.append((s0 + sl, q * L - (shard * S + s0 + sl) * R))
            x = torch.stack(xs)  # [B, re/im, n]
            xr = x[:, 0].reshape(-1, Q, Q).transpose(1, 2)  # [B, t, n2]
            xi = x[:, 1].reshape(-1, Q, Q).transpose(1, 2)
            Xr, Xi = _fft(xr, xi, tab, Q)  # [B, t, k] = X[t + Q k]
            hr = tab[2].reshape(Q, Q).T  # [t, k] = H[t + Q k]
            hi = tab[3].reshape(Q, Q).T
            Zr, Zi = _cmul(Xr, Xi, hr, hi)
            Yr, Yi = _fft(Zr, -Zi, tab, Q)  # [B, t, m] = y'[t + Q m]
            yr = Yr[:, :, Q // 2:].transpose(1, 2).reshape(-1, L)  # p = t + Q m'
            yi = -Yi[:, :, Q // 2:].transpose(1, 2).reshape(-1, L)
            for b, (s, k0) in enumerate(where):
                for p in range(L):
                    k = k0 + p
                    if r0 <= k < r0 + T and k % D == 0:
                        out[k // D, s] = yr[b, p]
                        out[k // D, S + s] = yi[b, p]
    return out


def _plain(ph0, first, taps, D, R, shard=0):
    return fir_source.fir_tone_step_plain(ph0, DP, 0.8, first,
                                          torch.from_numpy(taps), D, R, shard)


def _exact(ph0, first, taps, D, R):
    """float64 convolution of the same float32 samples."""
    W = len(taps) - 1
    idx = folded_index(R, -W, W + R, "cpu")
    x = mask_before_stream(folded_values(ph0, DP, 0.8, idx), idx, first)
    x = x.double().numpy()
    out = np.zeros((R // D, 2 * S))
    for t, c in enumerate(taps.astype(np.float64)):
        out += c * x[W - t:W - t + R:D][:R // D]
    return out


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("ph0,first", [(0xFFFFF000, True), (0x9E3779B9, False)])
def test_fft_form_matches_plain_and_float64(D, ph0, first):
    R, taps = 256, _taps()
    got = fir_fft_model(ph0, DP, 0.8, first, taps, D, R)
    ref = _plain(ph0, first, taps, D, R).numpy()
    exact = _exact(ph0, first, taps, D, R)
    assert got.shape == (R // D, 2 * S) and torch.isfinite(got).all()
    scale = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() <= REL_TOL * scale
    assert np.abs(got.numpy() - ref).max() <= REL_TOL * scale
    assert np.abs(ref - exact).max() <= REL_TOL * scale


@pytest.mark.parametrize("ntaps", [33, 65, 200])
def test_fft_form_at_other_radices(ntaps):
    """33 taps take N = 64 (Q = 8), 65 taps N = 256 with L = 128 > 64, 200
    taps N = 1024 (Q = 32), whose L = 512 does not divide R."""
    R, taps = 128, _taps(ntaps)
    got = fir_fft_model(0x1234, DP, 0.8, True, taps, 1, R)
    ref = _plain(0x1234, True, taps, 1, R).numpy()
    assert np.abs(got.numpy() - ref).max() <= REL_TOL * np.abs(ref).max()


def test_fft_form_bit_identical_across_blocks_splits_and_shards():
    """Two tiles, two segment groups; a batch of R against two of R/2 (the
    split at 64*R/2 samples, a multiple of L); time shards 0 and 1 of R/2
    rows against the whole batch."""
    R, taps, ph0 = 256, _taps(), 0x00000100
    base = fir_fft_model(ph0, DP, 0.8, True, taps, 1, R)
    assert torch.equal(base, fir_fft_model(ph0, DP, 0.8, True, taps, 1, R,
                                           tile=128))
    assert torch.equal(base, fir_fft_model(ph0, DP, 0.8, True, taps, 1, R,
                                           seg_group=16))
    h = R // 2
    halves = [fir_fft_model(ph0, DP, 0.8, True, taps, 1, h),
              fir_fft_model(nco.nco_advance(ph0, DP, 64 * h), DP, 0.8, False,
                            taps, 1, h)]
    shards = [fir_fft_model(ph0, DP, 0.8, True, taps, 1, h, shard=d)
              for d in (0, 1)]
    unfold = fir_source.unfold_complex
    whole = unfold(base)
    assert torch.equal(whole, torch.cat([unfold(x) for x in halves]))
    assert torch.equal(whole, torch.cat([unfold(x) for x in shards]))


@pytest.mark.parametrize("R,tile", [(100, None), (100, 50), (160, 40)])
def test_fft_form_where_l_does_not_divide_r(R, tile):
    """Transforms that reach past a block's tile are computed whole; the
    window grows by their rows. Within tolerance of the plain version, and
    bit-equal across tiles."""
    taps = _taps()
    got = fir_fft_model(0xFFFFF000, DP, 0.8, True, taps, 1, R, tile=tile)
    ref = _plain(0xFFFFF000, True, taps, 1, R).numpy()
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref).max() <= REL_TOL * np.abs(ref).max()
    one = fir_fft_model(0xFFFFF000, DP, 0.8, True, taps, 1, R, tile=R)
    assert torch.equal(got, one)


def test_table_values():
    taps = _taps()
    tab = fir_source.fir_tone_table(taps, 16)
    N = 256
    w = np.exp(-2j * np.pi * np.arange(N) / N)
    h = np.fft.fft(np.concatenate([taps.astype(np.float64),
                                   np.zeros(N - NTAPS)])) / N
    assert tab.dtype == np.float32 and tab.shape == (4, N)
    np.testing.assert_array_equal(tab[0] + 1j * tab[1], w.astype(np.complex64))
    np.testing.assert_array_equal(tab[2] + 1j * tab[3], h.astype(np.complex64))
    consts = fir_source.fir_tone_consts(taps, "cpu")
    assert torch.equal(consts.fft, torch.from_numpy(tab))
    assert torch.equal(consts.taps, torch.from_numpy(taps))


def test_radix_and_geometry():
    assert [fir_source.fft_radix(n) for n in (1, 33, 34, 128, 129, 130, 513)] \
        == [8, 8, 16, 16, 16, 32, 32]
    g = fir_source._geometry(32768, 1, NTAPS, None, fir_source.SEG_GROUP)
    assert (g.Q, g.T, g.GS, g.NQ, g.off, g.WR, g.BR) == (16, 512, 8, 4, 128, 640, 256)
    assert g.PW % 2 == 1 and g.smem <= fir_source._SMEM_MAX
    g = fir_source._geometry(100, 1, NTAPS, None, 8)  # L does not divide R
    assert (g.T, g.NQ, g.off, g.WR, g.BR) == (100, 2, 255, 100 + 3 * 128 - 2, 0)
    assert fir_source.window_stride(8, 8) == 10
    with pytest.raises(ValueError, match="seg_group"):
        fir_source._geometry(256, 1, NTAPS, None, 4)
    # past the FFT's 513 taps the wrapper plans the direct instance, whose
    # window fits up to its stated limit and is refused past it
    assert fir_source.FFT_MAX_TAPS == 513
    assert isinstance(fir_source.plan(32768, 1, 513), fir_source._Geometry)
    for nt in (514, 1000):
        d = fir_source.plan(32768, 1, nt)
        assert isinstance(d, fir_source._Direct)
        assert (d.T, d.GS, d.CU) == (512, 4, 576)
        assert d.smem <= fir_source._SMEM_MAX
    # 36 bytes a tap, and 16 KB of window at 512 rows and 4 segments
    assert fir_source.plan(32768, 1, 1024).smem == 53248
    limit = fir_source.direct_max_taps(1, 512)
    assert limit == 6001
    assert fir_source.plan(32768, 1, limit).smem <= fir_source._SMEM_MAX
    with pytest.raises(ValueError, match=f"at most {limit} taps"):
        fir_source.plan(32768, 1, limit + 1)
    consts = fir_source.fir_tone_consts(np.ones(1000, np.float32), "cpu")
    assert consts.fft is None  # the direct instance reads the taps alone


def test_cuda_wrapper_refuses_consts_without_the_table():
    consts = fir_source.fir_tone_consts(_taps(), "meta")
    assert consts.fft.device.type == "meta" and consts.fft.shape == (4, 256)
    for bad in (consts._replace(fft=None), consts.taps):
        with pytest.raises(ValueError, match="twiddle table"):
            fir_source.fir_tone_step(0, DP, 0.8, True, bad, 1, 256)
    assert fir_source.fir_tone_step.launches == 0


def test_live_chain_past_the_fft_taps_against_golden():
    """``fir_chain(ntaps=1024, source="live")`` runs on the CPU through K9's
    plain version, the function of the direct instance its wrapper plans
    on the card for that many taps: > 100 dB against the float64 golden
    over two batches of 8192 samples."""
    from newsched_tpu_torch import models, testing

    n, nt, fs, freq = 2 * 8192, 1024, 1e6, 123_456.0
    fg, b = models.fir_chain(n_samples=n, fs=fs, ntaps=nt, frequency=freq,
                             batch_size=8192, sink="vector", source="live")
    fg.run(device="cpu")
    got = np.asarray(b["sink"].data())
    assert isinstance(fir_source.plan(8192 // 64, 1, nt), fir_source._Direct)
    ref = testing.fir_golden(n, b["taps"], freq, fs)
    assert got.shape == (n,) and testing.snr_db(ref, got) > 100
    assert fir_source.fir_tone_step.direct_launches == 0
