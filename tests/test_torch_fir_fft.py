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
Past 513 taps, the partitioned instance (csrc/fir_part.cu) the same way:
its transforms, the partitions' spectra summed in the kernel's order, its
table, its plan and its limit.
"""

import numpy as np
import pytest
import torch

from newsched_tpu_torch.ops import firdes, nco
from newsched_tpu_torch.ops.cuda import fir_source
from newsched_tpu_torch.ops.cuda.mathfns import sin_cos_turns_plain
from newsched_tpu_torch.ops.cuda.sources import (folded_index, folded_values,
                                                 mask_before_stream, nco_turns,
                                                 shard_phase)

FS, FREQ, NTAPS, S = 1e6, 123_456.0, 128, 64
DP = nco.freq_to_dphase(FREQ, FS)
# |FFT form - float64| and |FFT form - plain| over max|out|: FP32 rounding
# of two 256-point transforms and the spectrum product, a few ulp of the
# largest value a transform holds (measured at 128 taps: the FFT form
# 3.9e-7 from float64, the direct form's 128-term sums 6.5e-7, the two
# 8.2e-7 apart)
REL_TOL = 2e-6
# |partitioned form - plain| over max|out| past 513 taps: the plain version
# (the direct form) sums its ntaps products in float32, and drifts from
# float64 as they grow (measured: 1.3e-6 at 514 taps, 1.9e-6 at 1024, 2.7e-6
# at 1500); the partitioned form stays within REL_TOL of float64 (7.1e-7)
PART_PLAIN_TOL = 5e-6


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


def _samples(ph, amp, first, shard, idx):
    """(re, im) float32 of the folded tone at batch indices ``idx``, as
    ``folded_values`` and ``mask_before_stream`` give them."""
    sn, cs = sin_cos_turns_plain(nco_turns(ph, DP, idx))
    a = torch.tensor(amp, dtype=torch.float32)
    re, im = cs * a, sn * a
    if shard == 0 and first:
        zero = torch.zeros(())
        re, im = torch.where(idx < 0, zero, re), torch.where(idx < 0, zero, im)
    return re, im


def fir_part_model(ph0, dp, amp, first, taps, D, R, tile=None,
                   seg_group=None, shard=0):
    """K9's partitioned instance as the kernel computes it, block by block:
    each block's slots (segment i % GS, the (i // GS)-th output block
    touching the tile), each output block's P forward transforms of the
    samples generated at their batch indices, times the partitions'
    spectra and summed p = 0 .. P-1, the inverse transform of the
    conjugate, its kept half written to the block's own rows. Rows no
    block writes stay NaN."""
    assert dp == DP
    g = fir_source.plan(R, D, len(taps), tile, seg_group)
    assert isinstance(g, fir_source._Part)
    Q, L = fir_source.PART_Q, fir_source.PART_L
    N = Q * Q
    tab = torch.from_numpy(fir_source.fir_part_table(taps))
    ph = shard_phase(ph0, dp, shard, R)
    seg, base, dest = [], [], []
    for r0 in range(0, R, g.T):
        for s0 in range(0, S, g.GS):
            jb = (shard * S + s0) * R + r0
            for i in range(g.GS * g.NQ):
                sl, iq = i % g.GS, i // g.GS
                dl = (jb + sl * R) % L
                if iq > (dl + g.T - 1) // L:
                    continue
                seg.append(s0 + sl)
                base.append(r0 + iq * L - dl - L)
                dest.append((s0 + sl, r0, r0 + iq * L - dl))
    seg, base = torch.tensor(seg)[:, None], torch.tensor(base)[:, None]
    n = torch.arange(N)[None, :]
    for p in range(g.P):
        re, im = _samples(ph, amp, first, shard, seg * R + base - p * L + n)
        xr = re.reshape(-1, Q, Q).transpose(1, 2)  # [B, t, n2]
        xi = im.reshape(-1, Q, Q).transpose(1, 2)
        Xr, Xi = _fft(xr, xi, tab, Q)  # [B, t, k] = X[t + Q k]
        hr = tab[2 + 2 * p].reshape(Q, Q).T  # [t, k] = H_p[t + Q k]
        hi = tab[3 + 2 * p].reshape(Q, Q).T
        Zr, Zi = _cmul(Xr, Xi, hr, hi)
        if p == 0:
            Ar, Ai = Zr, Zi
        else:
            Ar, Ai = Ar + Zr, Ai + Zi
    Yr, Yi = _fft(Ar, -Ai, tab, Q)  # [B, t, m] = y'[t + Q m]
    yr = Yr[:, :, Q // 2:].transpose(1, 2).reshape(-1, L)  # p = t + Q m'
    yi = -Yi[:, :, Q // 2:].transpose(1, 2).reshape(-1, L)
    out = torch.full((R // D, 2 * S), float("nan"))
    for b, (s, r0, k0) in enumerate(dest):
        k = k0 + torch.arange(L)
        keep = (k >= r0) & (k < r0 + g.T) & (k % D == 0)
        out[k[keep] // D, s] = yr[b, keep]
        out[k[keep] // D, S + s] = yi[b, keep]
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
    # past the FFT's 513 taps the wrapper plans the partitioned instance:
    # partitions of 512 taps, any count up to its stated limit (at least the
    # 6001 taps at D = 1 and 3421 at D = 4 that the direct form took),
    # refused past it
    assert fir_source.FFT_MAX_TAPS == 513
    assert isinstance(fir_source.plan(32768, 1, 513), fir_source._Geometry)
    for nt, D, P in ((514, 1, 2), (1000, 1, 2), (1025, 1, 3), (6001, 1, 12),
                     (3421, 4, 7)):
        d = fir_source.plan(32768, D, nt)
        assert isinstance(d, fir_source._Part)
        assert (d.T, d.GS, d.NQ, d.P, d.BR) == (512, 16, 1, P, 512 // D)
        # the round's tile, then what does not depend on the taps
        assert d.smem == 8 * 8 * d.BR + 141440 <= fir_source._SMEM_MAX
    g = fir_source.plan(100, 1, 1000)  # L does not divide R: 16-byte stores
    assert (g.T, g.NQ, g.P, g.BR) == (100, 2, 2, 0)
    limit = fir_source.PART_MAX_TAPS
    assert limit == 32768 and fir_source.plan(32768, 1, limit).P == 64
    with pytest.raises(ValueError, match=f"at most {limit} taps"):
        fir_source.plan(32768, 1, limit + 1)
    consts = fir_source.fir_tone_consts(np.ones(1000, np.float32), "cpu")
    assert consts.fft.shape == (6, 1024)  # the partitioned instance's table


def test_cuda_wrapper_refuses_consts_without_the_table():
    consts = fir_source.fir_tone_consts(_taps(), "meta")
    assert consts.fft.device.type == "meta" and consts.fft.shape == (4, 256)
    for bad in (consts._replace(fft=None), consts.taps):
        with pytest.raises(ValueError, match="twiddle table"):
            fir_source.fir_tone_step(0, DP, 0.8, True, bad, 1, 256)
    assert fir_source.fir_tone_step.launches == 0


def test_live_chain_past_the_fft_taps_against_golden():
    """``fir_chain(ntaps=1024, source="live")`` runs on the CPU through K9's
    plain version, the function of the partitioned instance its wrapper
    plans on the card for that many taps: > 100 dB against the float64
    golden over two batches of 8192 samples."""
    from newsched_tpu_torch import models, testing

    n, nt, fs, freq = 2 * 8192, 1024, 1e6, 123_456.0
    fg, b = models.fir_chain(n_samples=n, fs=fs, ntaps=nt, frequency=freq,
                             batch_size=8192, sink="vector", source="live")
    fg.run(device="cpu")
    got = np.asarray(b["sink"].data())
    assert isinstance(fir_source.plan(8192 // 64, 1, nt), fir_source._Part)
    ref = testing.fir_golden(n, b["taps"], freq, fs)
    assert got.shape == (n,) and testing.snr_db(ref, got) > 100
    assert fir_source.fir_tone_step.partitioned_launches == 0


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("ntaps", [514, 1024, 1500])
def test_partitioned_form_matches_plain_and_float64(ntaps, D):
    """2, 2 and 3 partitions, at R = 512 (one output block a segment and a
    tile), from stream start at D = 1 and from a nonzero phase at D = 4."""
    ph0, first = (0xFFFFF000, True) if D == 1 else (0x9E3779B9, False)
    R, taps = 512, _taps(ntaps)
    got = fir_part_model(ph0, DP, 0.8, first, taps, D, R)
    ref = _plain(ph0, first, taps, D, R).numpy()
    exact = _exact(ph0, first, taps, D, R)
    assert got.shape == (R // D, 2 * S) and torch.isfinite(got).all()
    scale = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() <= REL_TOL * scale
    assert np.abs(got.numpy() - ref).max() <= PART_PLAIN_TOL * scale


def test_partitioned_form_bit_identical_across_blocks_splits_and_shards():
    """1024 taps: tile 256 (each output block then computed whole for half
    its rows) and 8 segments a block against the default (16); a batch of
    R = 512 against two of R/2 (the split at 64*R/2 samples, a multiple of
    L = 512); time shards 0 and 1 of R/2 rows against the whole batch."""
    R, taps, ph0 = 512, _taps(1024), 0x00000100
    base = fir_part_model(ph0, DP, 0.8, True, taps, 1, R)
    assert torch.isfinite(base).all()
    assert torch.equal(base, fir_part_model(ph0, DP, 0.8, True, taps, 1, R,
                                            tile=256))
    assert torch.equal(base, fir_part_model(ph0, DP, 0.8, True, taps, 1, R,
                                            seg_group=8))
    h = R // 2
    halves = [fir_part_model(ph0, DP, 0.8, True, taps, 1, h),
              fir_part_model(nco.nco_advance(ph0, DP, 64 * h), DP, 0.8, False,
                             taps, 1, h)]
    shards = [fir_part_model(ph0, DP, 0.8, True, taps, 1, h, shard=d)
              for d in (0, 1)]
    unfold = fir_source.unfold_complex
    whole = unfold(base)
    assert torch.equal(whole, torch.cat([unfold(x) for x in halves]))
    assert torch.equal(whole, torch.cat([unfold(x) for x in shards]))


@pytest.mark.parametrize("R,tile", [(100, None), (100, 50), (160, 40)])
def test_partitioned_form_where_l_does_not_divide_r(R, tile):
    """Output blocks that reach past a block's tile are computed whole:
    within tolerance of the plain version, bit-equal across tiles."""
    taps = _taps(700)
    got = fir_part_model(0xFFFFF000, DP, 0.8, True, taps, 1, R, tile=tile)
    ref = _plain(0xFFFFF000, True, taps, 1, R).numpy()
    assert torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref).max() <= PART_PLAIN_TOL * np.abs(ref).max()
    one = fir_part_model(0xFFFFF000, DP, 0.8, True, taps, 1, R, tile=R)
    assert torch.equal(got, one)


def test_partitioned_table_values():
    """W_N^j and each partition's spectrum over N, float64 rounded once;
    the last partition zero-padded."""
    taps = _taps(1300)
    tab = fir_source.fir_part_table(taps)
    N, L = 1024, 512
    assert fir_source.part_count(1300) == 3
    assert tab.dtype == np.float32 and tab.shape == (2 + 2 * 3, N)
    np.testing.assert_array_equal(tab[:2],
                                  fir_source.fir_tone_table(taps[:L], 32)[:2])
    for p in range(3):
        h = np.zeros(N)
        part = taps[p * L:(p + 1) * L].astype(np.float64)
        h[:len(part)] = part
        spec = (np.fft.fft(h) / N).astype(np.complex64)
        np.testing.assert_array_equal(tab[2 + 2 * p] + 1j * tab[3 + 2 * p], spec)
    consts = fir_source.fir_tone_consts(taps, "cpu")
    assert torch.equal(consts.fft, torch.from_numpy(tab))
