"""The planes DFT as the kernels' shared-memory FFT (csrc/planes_fft.cuh:
stage 2 of the chains' tile routines in csrc/fm_chain.cu and K1 in
csrc/channelizer.cu at M = 64 P, P = 1 .. 16), held on the CPU at every
width: the radix-P step (P = 5 and 7 from the pairs x[m] +- x[P-m], P = 6
as 2 x 3; past P = 7 two passes, P = P1 x P2, by the prime-factor map or
with twiddles, 11 and 13 from the pairs) and the P 8 x 8 FFTs evaluated
in torch float32 (``planes_fft.fft_planes``) with the twiddle table the
constants carry, in the kernels' order of operations, each rounded on its
own as the kernels' ``__fadd_rn``/``__fmul_rn`` are, against the plain
versions' dense product ``acc @ planes_dft_matrix(M)`` and against
numpy's float64 FFT with the post-twiddle. K1's path (the fold on
interleaved lanes, the FFT on planes rows, interleaved out) against its
plain version and the reference's ``arm_fold_dft`` in interpret mode.
The tables and the replay at P <= 7 are pinned to their hashes, so the
wider P changed none of their operations. Also: every ``FmChainConsts``
carries the table, the CUDA wrappers refuse constants without it, and
K3, K5 and K6 plan every width the FFT takes and refuse the widths past
it (meta tensors stand in for the card: those checks come before any
launch); pfb_channelize's "auto" takes K1 at those widths and K7 elsewhere.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.ops import firdes as jfirdes, pfb as jpfb
from newsched_tpu.ops.pallas import channelizer as jch, fm_chain as jfm

from newsched_tpu_torch.ops import firdes, pfb
from newsched_tpu_torch.ops.cuda import channelizer, fm_chain, noise, planes_fft
from newsched_tpu_torch.probes import ablate

WIDTHS = planes_fft.CHANNELS  # M = 64 P, P = 1 .. 16
# |FFT - exact| and |dense product - exact| over the row's largest exact
# output: FP32 rounding of the transform, a few ulp of the largest output
# (measured on the random rows: up to 2.6e-7 for the FFT, 1.2e-6 for the
# dense product at M = 192)
REL_TOL = 1e-6
# the chains' plain versions against the reference's fm_chain_step_planes
# (interpret mode, HIGHEST) on the same rows, as tests/test_torch_live.py
# holds K5's at M = 64 (measured at M = 320: 8.2e-7 of the audio's 1.7)
CHAIN_RTOL, CHAIN_ATOL = 2e-4, 2e-5
# K1's path against its plain version and the reference, relative to
# max|out|: the fold's FMA against separate products and sums, and the FFT
# against a dense FP32 product (measured 4e-7)
FOLD_TOL = 1e-5


def _exact(acc: np.ndarray) -> np.ndarray:
    """numpy's float64 FFT of a = re + i im, then the post-twiddle."""
    M = acc.shape[1] // 2
    a = acc[:, :M].astype(np.float64) + 1j * acc[:, M:].astype(np.float64)
    y = np.fft.fft(a, axis=1) * np.exp(-2j * np.pi * np.arange(M) / M)
    return np.concatenate([y.real, y.imag], axis=1)


def _rows(case: str, M: int) -> np.ndarray:
    if case == "random":  # channel amplitudes about 8, as the FM band's
        rng = np.random.default_rng(9)
        return (rng.standard_normal((256, 2 * M)) * 8).astype(np.float32)
    if case == "impulse":  # 1 at every lane in turn, re lanes then im
        return np.eye(2 * M, dtype=np.float32)
    return np.zeros((4, 2 * M), np.float32)


@pytest.mark.parametrize("M", WIDTHS)
@pytest.mark.parametrize("case", ["random", "impulse", "zero"])
def test_fft_with_the_table_is_the_planes_dft(case, M):
    acc = _rows(case, M)
    table = fm_chain.fm_chain_consts(np.ones((4, M), np.float32),
                                     np.ones(5, np.float32), "cpu").fft
    got = planes_fft.fft_planes(torch.from_numpy(acc), table).numpy()
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
    if case == "impulse":  # a few products per output: exact to a few ulp
        np.testing.assert_allclose(got, dense, rtol=0, atol=4e-7)


@pytest.mark.parametrize("M", WIDTHS)
def test_fft_table_values(M):
    tab = fm_chain.planes_fft_table(M)
    assert tab.dtype == np.float32 and tab.shape == (4, M)
    n1, k1 = np.divmod(np.arange(64), 8)
    inner = np.exp(-2j * np.pi * n1 * k1 / 64).astype(np.complex64)
    post = np.exp(-2j * np.pi * np.arange(M) / M).astype(np.complex64)
    np.testing.assert_array_equal(tab[0, :64] + 1j * tab[1, :64], inner)
    assert not tab[:2, 64:].any()  # rows 0/1 past the 8 x 8 FFT's 64
    np.testing.assert_array_equal(tab[2] + 1j * tab[3], post)
    assert tab[2, M // 8] == np.float32(np.sqrt(0.5))  # cos(pi/4)
    if M % 192 == 0:  # -Im e^{-2 pi i/3} = sin(pi/3), the radix-3 steps'
        assert -tab[3, M // 3] == np.float32(np.sqrt(3) / 2)
    P = M // 64  # the P-point DFT's cos and sin of 2 pi a / P at j = 64 a
    w = np.exp(-2j * np.pi * np.arange(P) / P).astype(np.complex64)
    np.testing.assert_array_equal(tab[2, ::64] + 1j * tab[3, ::64], w)
    for m in (16, 48, 1088):  # no kernel FFT: no kernel takes these widths
        assert fm_chain.planes_fft_table(m) is None


# sha256 (first 16 hex digits) of planes_fft_table(M) and of fft_planes on
# 64 seeded rows, as the P <= 4 code computed them before P = 5-7 existed
P4_HASHES = {64: ("11a9fb3da3e68355", "6cb776e78400239d"),
             128: ("581167d807aada67", "c39697143e49a346"),
             192: ("bf7adb129670430c", "847672770ddd348f"),
             256: ("012a5c3fadbd8279", "337574c66c131add")}


# the same at P = 5 .. 7, as the one-pass radix-P step computed them before
# the two passes past P = 7 existed
P7_HASHES = {320: ("59fa0631b4e8c138", "aab4f138c9ecee6a"),
             384: ("d6cdb8e8fd658c0f", "d8a67a210edb372e"),
             448: ("826cbe442d7253c2", "40f41e7a4f34006e")}


def _table_and_replay_hashes(M):
    tab = planes_fft.planes_fft_table(M)
    rows = (np.random.default_rng(M).standard_normal((64, 2 * M)) * 8
            ).astype(np.float32)
    y = planes_fft.fft_planes(torch.from_numpy(rows), torch.from_numpy(tab))

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    return h(tab), h(y.numpy())


@pytest.mark.parametrize("M", sorted(P7_HASHES))
def test_p5_to_p7_tables_and_replay_are_unchanged(M):
    """K1's and the chains' widths 320-448 keep their table and their
    replay's bits (so the kernels' P = 5 .. 7 arithmetic is untouched)."""
    assert _table_and_replay_hashes(M) == P7_HASHES[M]


@pytest.mark.parametrize("P", range(8, 17))
def test_two_pass_plans_cover_every_part(P):
    """Past P = 7 the radix step's two passes (``planes_fft.plan``): P =
    P1 x P2 with P1, P2 among the DFTs the kernels hold (2, 3, 4, 5, 7, 8,
    11, 13); each pass's columns take every part of the row once; the
    prime-factor map's outputs (e1 k1 + e2 k2) mod P are the q with q mod
    P1 = k1 and q mod P2 = k2; every output q has one part, and the
    table's entries the passes read lie inside it."""
    pl = planes_fft.plan(P)
    assert pl.P1 * pl.P2 == P
    assert pl.P1 in (2, 3, 4, 8, 11, 13) and pl.P2 in (1, 3, 4, 5, 7)
    assert pl.pfa == (pl.P2 > 1 and np.gcd(pl.P1, pl.P2) == 1)
    cells = [(a, b) for a in range(pl.P1) for b in range(pl.P2)]
    assert sorted(planes_fft._slot(pl, a, b) for a, b in cells) == list(range(P))
    outs = [planes_fft._out(pl, a, b) for a, b in cells]
    assert sorted(outs) == list(range(P))
    if pl.pfa:
        assert all(q % pl.P1 == a and q % pl.P2 == b
                   for q, (a, b) in zip(outs, cells))
    parts = [planes_fft.slot_of(P, q) for q in range(P)]
    assert sorted(parts) == list(range(P))
    assert all(planes_fft.slot_of(P, planes_fft._out(pl, a, b))
               == planes_fft._slot(pl, a, b) for a, b in cells)
    M = 64 * P  # twiddles 64 j2 k1 and n q, and the DFTs' a M / F
    assert 64 * (pl.P1 - 1) * (pl.P2 - 1) < M and 63 * (P - 1) < M
    assert M % pl.P1 == 0 and M % pl.P2 == 0


@pytest.mark.parametrize("M", sorted(P4_HASHES))
def test_p4_tables_and_replay_are_unchanged(M):
    """The chains' widths keep their table and their replay's bits (so the
    kernels' P <= 4 arithmetic, which the replay repeats, is untouched)."""
    tab = planes_fft.planes_fft_table(M)
    rows = (np.random.default_rng(M).standard_normal((64, 2 * M)) * 8
            ).astype(np.float32)
    y = planes_fft.fft_planes(torch.from_numpy(rows), torch.from_numpy(tab))

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    assert (h(tab), h(y.numpy())) == P4_HASHES[M]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("M", WIDTHS)
def test_consts_carry_the_table_on_every_device(device, M):
    consts = fm_chain.fm_chain_consts(np.ones((16, M), np.float32),
                                      np.ones(65, np.float32), device)
    assert consts.fft.device.type == device
    assert consts.fft.dtype == torch.float32 and consts.fft.shape == (4, M)
    if device == "cpu":
        assert torch.equal(consts.fft,
                           torch.from_numpy(fm_chain.planes_fft_table(M)))
    p = pfb.pfb_consts(np.ones((M, 4), np.float32), device)
    assert p.fft.shape == (4, M) and p.fft.device.type == device


def _fold_case(M, L, n_out, seed):
    """Interleaved commutator rows and fold taps of a real channelizer."""
    taps = firdes.prototype_channelizer_taps(M, L)
    c = np.ascontiguousarray(pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T)
    rng = np.random.default_rng(seed)
    V = ((rng.standard_normal((n_out + L - 1, M))
          + 1j * rng.standard_normal((n_out + L - 1, M))) * 0.5
         ).astype(np.complex64)
    v = np.ascontiguousarray(np.stack([V.real, V.imag], -1).reshape(
        n_out + L - 1, 2 * M))
    return v, c


@pytest.mark.parametrize("M", [64, 128, 320, 384, 448, 512, 1024])
def test_k1_fold_then_fft_is_arm_fold_dft(M):
    """K1's FFT instance in torch float32: the fold on the interleaved
    lanes (K7's plain version), the planes FFT of its rows, interleaved
    out (``channelizer.fft_interleaved``), against ``arm_fold_dft_plain``
    (the fold, then the dense product) and the reference's
    ``arm_fold_dft`` in interpret mode, within FOLD_TOL of max|out|."""
    L, n_out = 16, 256
    v, c = _fold_case(M, L, n_out, seed=M)
    c2 = torch.from_numpy(channelizer.interleave_taps(c))
    w2 = torch.from_numpy(channelizer.interleaved_dft_matrix(M))
    table = torch.from_numpy(planes_fft.planes_fft_table(M))
    vt = torch.from_numpy(v)
    got = channelizer.fft_interleaved(
        channelizer.arm_fold_plain(vt, c2, n_out), table).numpy()
    plain = channelizer.arm_fold_dft_plain(vt, c2, w2, n_out).numpy()
    ref = np.asarray(jch.arm_fold_dft(jnp.asarray(v), c2.numpy(), w2.numpy(),
                                      n_out, tile=128, interpret=True))
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (n_out, 2 * M)
    assert np.abs(got - plain).max() <= FOLD_TOL * scale
    assert np.abs(got - ref).max() <= FOLD_TOL * scale
    # the planes rows K1 transforms are the fold's re lanes, then its im
    acc = channelizer.arm_fold_plain(vt, c2, n_out)
    planes = torch.cat([acc[:, 0::2], acc[:, 1::2]], dim=1)
    Y = planes_fft.fft_planes(planes, table)
    assert torch.equal(torch.from_numpy(got[:, 0::2]), Y[:, :M])
    assert torch.equal(torch.from_numpy(got[:, 1::2]), Y[:, M:])


def _meta_case(M=64, n=256):
    L, A, decim = 16, 65, 8
    consts = fm_chain.fm_chain_consts(np.ones((L, M), np.float32),
                                      np.ones(A, np.float32), "meta")
    z = dict(dtype=torch.float32, device="meta")
    st = (torch.zeros(16, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    return consts, torch.zeros(n, 2 * M, **z), st, decim


def _calls(consts, vb, halo, prev, tail, decim):
    return {
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


@pytest.mark.parametrize("kernel", ["K3", "K3p", "K5", "K6", "ablate"])
def test_cuda_wrappers_refuse_consts_without_the_table(kernel):
    consts, vb, (halo, prev, tail), decim = _meta_case()
    with pytest.raises(ValueError, match="twiddle table"):
        _calls(consts._replace(fft=None), vb, halo, prev, tail,
               decim)[kernel]()


@pytest.mark.parametrize("M", [128, 192, 256, 320, 384, 448, 512, 576, 640,
                               704, 768, 832, 896, 960, 1024])
@pytest.mark.parametrize("kernel", ["K3", "K5", "K6"])
def test_chain_kernels_plan_every_fft_width(kernel, M):
    """At the flagship's A = 65, L = 16, decim 8 and batch, K3, K5 and K6
    plan M = 128 .. 1024: the default tile of 128 rows, whose block fits the
    H100's shared memory (chain_tile_wide's layout at every one of them:
    its folded rows a pass, 64 at M = 128, 32 up to M = 448 and 16 past
    it, the Y row kept for the pass below, the tile's 16 x M audio
    accumulators, up to M = 256 a ring of a pass's input rows, and the A
    audio taps), every check passed up to
    the tensors' device, which the meta tensors here fail. K3p and the
    ablation stay at M = 64 and say so; M = 1088 (past 1024) is refused
    naming ROADMAP.md Queue 3, R1."""
    L, A, decim, n = 16, 65, 8, 32768
    consts, vb, (halo, prev, tail), _ = _meta_case(M, n)
    W = 2 * M
    tile = fm_chain._fit_tile(128, W, A, L, decim,
                              64 if kernel == "K6" else decim)
    smem = fm_chain._chain_smem(tile, A, L, 1, decim, W)
    assert tile == 128
    rows = 64 if M == 128 else 32 if M <= 448 else 16
    ring = (rows + L - 1) * W if M <= 256 else 0
    assert smem == ((rows + 1) * W + tile // decim * M + ring + A) * 4
    assert fm_chain._chain_smem(64, A, L, 1, decim, W) <= smem \
        <= fm_chain._SMEM_MAX
    fm_chain._check_kernel_shape(W, tile, A, L, 1, decim)
    for ag in (2, 4):  # K3ag's bands: the same block
        fm_chain._check_kernel_shape(W, tile, A, L, ag, decim)
    with pytest.raises(ValueError, match="on meta"):
        _calls(consts, vb, halo, prev, tail, decim)[kernel]()
    for flagship_only in ("K3p", "ablate"):
        with pytest.raises(ValueError, match="M=64"):
            _calls(consts, vb, halo, prev, tail, decim)[flagship_only]()
    with pytest.raises(ValueError, match="Queue 3, R1"):
        fm_chain._check_kernel_shape(2 * 1088, 64, A, L, 1, decim)


@pytest.mark.parametrize("M,route", [(64, "K1"), (448, "K1"), (512, "K1"),
                                     (576, "K7"), (1024, "K7"), (1088, "K7")])
def test_pfb_auto_routes_by_the_fft_widths(M, route, monkeypatch):
    """pfb_channelize's "auto" on a device tensor (meta stands in for the
    card): K1 (its planes FFT) at M = 64, 448 and 512, K7 and the combine
    past ``pfb.AUTO_K1_MAX`` = 512 (576 and 1024, where K7 and cuFFT's
    combine was the faster on the card), and past 1024 channels (1088), where
    K1 takes no width; each route goes as far as the device check, which
    meta fails."""
    taken = []
    for name in ("arm_fold_dft", "arm_fold"):
        real = getattr(channelizer, name)
        monkeypatch.setattr(channelizer, name,
                            lambda *a, _f=real, _n=name, **k:
                            (taken.append(_n), _f(*a, **k))[1])
    L, n_out = 16, 64
    arm = pfb.pfb_arm_taps(firdes.prototype_channelizer_taps(M, L), M)
    meta = dict(device="meta", dtype=torch.complex64)
    assert pfb.auto_method(M) == ("fused" if route == "K1" else "pallas")
    with pytest.raises(ValueError, match="on meta"):
        pfb.pfb_channelize(arm, pfb.PfbState(torch.zeros(M * L - 1, **meta)),
                           torch.zeros(n_out * M, **meta),
                           consts=pfb.pfb_consts(arm, "meta"))
    assert taken == ["arm_fold_dft" if route == "K1" else "arm_fold"]


def test_k1_refuses_widths_past_its_fft():
    """On a device tensor (meta stands in for the card) K1 takes M = 512
    and 1024 as far as the device check, and refuses 1088 channels and a
    width that is no multiple of 64 channels, naming ROADMAP.md Queue 3,
    R1; the plain version on the CPU takes any width."""
    meta = dict(device="meta", dtype=torch.float32)
    for M, ok in ((512, True), (1024, True), (1088, False), (544, False)):
        W = 2 * M
        v, c2, w2 = (torch.empty(64 + 15, W, **meta), torch.empty(16, W, **meta),
                     torch.empty(W, W, **meta))
        fft = None if planes_fft.planes_fft_table(M) is None else torch.empty(4, M, **meta)
        with pytest.raises(ValueError, match="on meta" if ok else "Queue 3, R1"):
            channelizer.arm_fold_dft(v, c2, w2, 64, fft=fft)
    v, c = _fold_case(1088 // 16, 4, 8, seed=1)
    out = channelizer.arm_fold_dft(torch.from_numpy(v),
                                   channelizer.interleave_taps(c),
                                   channelizer.interleaved_dft_matrix(68), 8)
    assert out.shape == (8, 136) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kernel", ["K3", "K5", "K6"])
def test_chain_plain_versions_at_320_match_reference(kernel):
    """At M = 320 (P = 5, the first width past 256 that the chains now
    take) the plain versions the kernels are held to on the card against
    the reference's fm_chain_step_planes in interpret mode (HIGHEST) on the
    same rows, within CHAIN_RTOL/CHAIN_ATOL: K3 on two carried batches of
    noise rows, K5 on its generated rows, K6 on a shard's window at group
    5 (warm 128 rows, the reference's recompute from a zero junction)."""
    _chain_plain_vs_reference(kernel, 320)


@pytest.mark.parametrize("kernel", ["K3", "K5", "K6"])
def test_chain_plain_versions_at_256_match_reference(kernel):
    """The same at M = 256 (P = 4, BASELINE config #4's 256-channel
    channelizer), two tiles' rows a batch."""
    _chain_plain_vs_reference(kernel, 256)


@pytest.mark.parametrize("kernel", ["K3", "K5", "K6"])
def test_chain_plain_versions_at_512_match_reference(kernel):
    """The same at M = 512 (P = 8, the first width of chain_tile_wide),
    two tiles' rows a batch."""
    _chain_plain_vs_reference(kernel, 512)


def _chain_plain_vs_reference(kernel, M):
    L, A, decim, n, gain = 16, 65, 8, 256, 0.7
    W = 2 * M
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    hi = jax.lax.Precision.HIGHEST

    def ref(rows, halo, prev, tail, warm=0):
        return jfm.fm_chain_step_planes(
            jnp.asarray(rows), jnp.asarray(halo), jnp.asarray(prev),
            jnp.asarray(tail), fold_c, ataps, decim, gain, warm=warm,
            tile=128, interpret=True, precision=hi)

    z = np.zeros
    pairs = []
    if kernel == "K6":
        warm, hr = 128, 128 + 16
        got = fm_chain.fm_chain_gen_warm_step(5, 0.5, consts, decim, gain, n,
                                              warm=warm, seed=4)
        rows = (noise.gaussian_rows_plain(5, n_rows=hr + n, width=W, seed=4,
                                          device="cpu", mask_pre=True,
                                          row0=-hr) * 0.5).numpy()
        ja, _, _ = ref(rows[hr:], rows[:hr], z((1, W), np.float32),
                       z((A - 1, W), np.float32), warm=warm)
        pairs.append((got, ja))
    else:
        halo, prev, tail = (z((16, W), np.float32), z((1, W), np.float32),
                            z((A - 1, W), np.float32))
        carry = torch.from_numpy(halo)
        tp, tt = torch.from_numpy(prev), torch.from_numpy(tail)
        for b in range(2):
            rows = (noise.gaussian_rows_plain(4 * b, n_rows=n, width=W, seed=4,
                                              device="cpu") * 0.5).numpy()
            if kernel == "K5":
                aud, tp, tt, carry = fm_chain.fm_chain_gen_step(
                    4 * b, 0.5, carry, tp, tt, consts, decim, gain, n, seed=4)
            else:
                aud, tp, tt = fm_chain.fm_chain_step_planes(
                    torch.from_numpy(rows), torch.from_numpy(halo), tp, tt,
                    consts, decim, gain)
            ja, jp, jt = ref(rows, halo, prev, tail)
            pairs += [(aud, ja), (tp, jp), (tt, jt)]
            halo, prev, tail = rows[-16:], np.asarray(jp), np.asarray(jt)
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
