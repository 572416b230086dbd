"""The port's ops held against the reference on the CPU: filter design,
the atan2 device function's plain version, the position-pure noise
stream, and the fused chain's plain version against the Pallas kernel in
interpret mode. CUDA is never built here: a CPU tensor takes each
wrapper's plain version, and the launch counts stay 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.ops import firdes as jfirdes, pfb as jpfb, window as jwindow
from newsched_tpu.ops.pallas import fm_chain as jfm, mathfns as jmath

from newsched_tpu_torch.ops import firdes, pfb, window
from newsched_tpu_torch.ops.cuda import fm_chain, mathfns, noise
from newsched_tpu_torch.testing import snr_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("win", ["hamming", "hann", "blackman",
                                 "blackman_harris", "rectangular", "kaiser"])
def test_window_equals_reference(win):
    for n in (5, 64, 129):
        np.testing.assert_array_equal(window.build(win, n, 7.0),
                                      jwindow.build(win, n, 7.0))
    assert window.max_attenuation(win, 7.0) == jwindow.max_attenuation(win, 7.0)


def test_firdes_and_arm_taps_equal_reference():
    cases = [
        (firdes.low_pass(1.0, 1.0, 0.05, 0.0125, ntaps=65),
         jfirdes.low_pass(1.0, 1.0, 0.05, 0.0125, ntaps=65)),
        (firdes.low_pass(2.0, 1e6, 100e3, 30e3), jfirdes.low_pass(2.0, 1e6, 100e3, 30e3)),
        (firdes.high_pass(1.0, 1e6, 100e3, 30e3), jfirdes.high_pass(1.0, 1e6, 100e3, 30e3)),
        (firdes.band_pass(1.0, 1e6, 1e5, 2e5, 3e4), jfirdes.band_pass(1.0, 1e6, 1e5, 2e5, 3e4)),
        (firdes.complex_band_pass(1.0, 1e6, 1e5, 2e5, 3e4),
         jfirdes.complex_band_pass(1.0, 1e6, 1e5, 2e5, 3e4)),
        (firdes.root_raised_cosine(1.0, 8.0, 1.0, 0.35, 45),
         jfirdes.root_raised_cosine(1.0, 8.0, 1.0, 0.35, 45)),
    ]
    for M, L in ((16, 8), (64, 16)):
        t, jt = (firdes.prototype_channelizer_taps(M, L),
                 jfirdes.prototype_channelizer_taps(M, L))
        cases += [(t, jt), (pfb.pfb_arm_taps(t, M), np.asarray(jpfb.pfb_arm_taps(jt, M))),
                  (pfb.pfb_arm_taps(t[:-5], M), np.asarray(jpfb.pfb_arm_taps(jt[:-5], M)))]
    for got, ref in cases:
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_atan2_plain_matches_reference_polynomial():
    np.testing.assert_array_equal(mathfns.ATAN_COEFFS, jmath._COEFFS_BY_DEG[9])
    vals = np.array([-3.0, -1.0, -1e-3, -0.0, 0.0, 1e-3, 1.0, 3.0], np.float32)
    rng = np.random.default_rng(0)
    y = np.concatenate([np.repeat(vals, len(vals)),
                        rng.standard_normal(20000).astype(np.float32)])
    x = np.concatenate([np.tile(vals, len(vals)),
                        rng.standard_normal(20000).astype(np.float32)])
    got = mathfns.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = np.asarray(jmath.atan2(jnp.asarray(y), jnp.asarray(x), deg=9))
    assert np.abs(got - ref).max() <= 1e-6
    # (+-0, +-0) -> +0 exactly: the zero-history demod convention
    zeros = (x == 0) & (y == 0)
    assert zeros.sum() == 4
    assert np.all(got[zeros] == 0) and not np.any(np.signbit(got[zeros]))
    # against float64, angles compared modulo 2 pi (signed-zero y on the
    # negative real axis: +pi here and in the reference, -pi in IEEE)
    f64 = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    f64[zeros] = 0.0
    assert np.abs(np.angle(np.exp(1j * (got - f64)))).max() <= 1e-6
    assert mathfns.atan2.launches == 0


def _rows(n, seed=0, hi=0, lo=0, width=128):
    return noise.gaussian_rows(noise.group64(hi, lo), n_rows=n, width=width,
                               seed=seed, device="cpu")


def test_noise_moments():
    """Irwin-Hall N=6 through Philox: the bounds of tests_tpu/test_noise.py."""
    r = _rows(8192, seed=5).double().numpy()
    n = r.size
    assert abs(r.mean()) < 5 / np.sqrt(n)
    assert abs(r.std() - 1.0) < 0.01
    assert np.abs(r).max() <= 4.25
    kurt = np.mean(r**4) / np.mean(r**2) ** 2 - 3.0
    assert abs(kurt - (-0.2)) < 0.05
    assert abs(np.corrcoef(r[:-1].ravel(), r[1:].ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(r[:, :-1].ravel(), r[:, 1:].ravel())[0, 1]) < 0.01
    assert noise.gaussian_rows.launches == 0


def test_noise_split_and_tile_invariance():
    """A pure function of (seed, absolute group): batch splits and the
    group-by-group generation a tile would do cannot change it."""
    whole = _rows(1024, seed=9)
    hi, lo = noise.advance_groups(0, 0, 256 // noise.GROUP_ROWS)
    assert torch.equal(whole[256:], _rows(1024 - 256, seed=9, hi=hi, lo=lo))
    groups = []
    for g in range(1024 // noise.GROUP_ROWS):
        ghi, glo = noise.advance_groups(0, 0, g)
        groups.append(_rows(noise.GROUP_ROWS, seed=9, hi=ghi, lo=glo))
    assert torch.equal(torch.cat(groups), whole)
    assert not torch.equal(whole, _rows(1024, seed=10))
    with pytest.raises(ValueError, match="multiple"):
        _rows(100)


def test_noise_group_counter_wraps_lo_into_hi():
    """The 64-bit group counter as int32 halves: lo = 0xFFFFFFFF advances
    into (hi + 1, 0), in the state update and inside one generation."""
    assert noise.advance_groups(0, -1, 1) == (1, 0)
    assert noise.advance_groups(5, 2**31 - 1, 1) == (5, -2**31)
    assert noise.advance_groups(-1, -1, 1) == (0, 0)
    assert noise.advance_groups(3, -2, 5) == (4, 3)
    two = _rows(2 * noise.GROUP_ROWS, seed=1, hi=7, lo=-1)
    assert torch.equal(two[noise.GROUP_ROWS:], _rows(noise.GROUP_ROWS, seed=1, hi=8, lo=0))
    assert not torch.equal(two[noise.GROUP_ROWS:], _rows(noise.GROUP_ROWS, seed=1, hi=7, lo=0))


def test_noise_philox_matches_known_answer():
    """Philox4x32-10 known-answer vectors (Random123's kat_vectors), so the
    CUDA kernel and the plain version implement the published generator."""
    def run(ctr, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        return [int(w) for w in noise._philox4x32_10(*c, *key)]

    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    m = 0xFFFFFFFF
    assert run((m, m, m, m), (m, m)) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def _chain_case(M, L, A, decim, n, seed):
    rng = np.random.default_rng(seed)
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    batches = [(rng.standard_normal((n, 2 * M)) * 0.5).astype(np.float32)
               for _ in range(2)]
    return fold_c, ataps, batches


def _run_jax(fold_c, ataps, batches, decim, gain, precision):
    M = fold_c.shape[1]
    H8 = jfm._round8(fold_c.shape[0] - 1)
    halo = np.zeros((H8, 2 * M), np.float32)
    prev = jnp.zeros((1, 2 * M), jnp.float32)
    tail = jnp.zeros((len(ataps) - 1, 2 * M), jnp.float32)
    outs = []
    for vb in batches:
        aud, prev, tail = jfm.fm_chain_step_planes(
            jnp.asarray(vb), jnp.asarray(halo), prev, tail, fold_c, ataps,
            decim, gain, tile=256, interpret=True, precision=precision)
        outs.append(tuple(np.asarray(a) for a in (aud, prev, tail)))
        halo = vb[-H8:]
    return outs


def _run_port(fold_c, ataps, batches, decim, gain):
    M = fold_c.shape[1]
    H8 = fm_chain._round8(fold_c.shape[0] - 1)
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    halo = torch.zeros(H8, 2 * M)
    prev, tail = torch.zeros(1, 2 * M), torch.zeros(len(ataps) - 1, 2 * M)
    outs = []
    for vb in batches:
        aud, prev, tail = fm_chain.fm_chain_step_planes(
            torch.from_numpy(vb), halo, prev, tail, consts, decim, gain)
        outs.append(tuple(a.numpy() for a in (aud, prev, tail)))
        halo = torch.from_numpy(vb[-H8:].copy())
    return outs


@pytest.mark.parametrize("M,L,A,decim,n", [(16, 8, 33, 4, 256),
                                           (64, 16, 65, 8, 1024)])
def test_fm_chain_plain_matches_pallas_highest(M, L, A, decim, n):
    """Two batches with carried state: audio, prev and tail within the
    tolerance of tests/test_pallas.py's fused-chain check."""
    fold_c, ataps, batches = _chain_case(M, L, A, decim, n, seed=M)
    ref = _run_jax(fold_c, ataps, batches, decim, 0.7,
                   jax.lax.Precision.HIGHEST)
    got = _run_port(fold_c, ataps, batches, decim, 0.7)
    for b, (g, r) in enumerate(zip(got, ref)):
        assert g[0].shape == (n // decim, M)
        for name, x, y in zip(("audio", "prev", "tail"), g, r):
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} batch {b}")
    assert fm_chain.fm_chain_step_planes.launches == 0


def test_fm_chain_plain_against_pallas_split3_snr():
    """Against the reference's default bf16x3 tier the FP32 port differs
    by that tier's own error only: >= 90 dB."""
    fold_c, ataps, batches = _chain_case(16, 8, 33, 4, 256, seed=3)
    ref = _run_jax(fold_c, ataps, batches, 4, 0.7, "split3")
    got = _run_port(fold_c, ataps, batches, 4, 0.7)
    for g, r in zip(got, ref):
        assert snr_db(r[0], g[0]) >= 90.0


def test_fm_chain_zero_history_emits_zero_demod():
    """All-zero input with zero state: the demod of every row is exactly 0
    (no signed-zero atan2 artefact), so audio and tail are exactly 0."""
    M, L, A = 16, 8, 33
    fold_c = np.ones((L, M), np.float32)
    consts = fm_chain.fm_chain_consts(fold_c, np.ones(A, np.float32), "cpu")
    z = torch.zeros
    aud, prev, tail = fm_chain.fm_chain_step_planes(
        -z(64, 2 * M), z(8, 2 * M), -z(1, 2 * M), z(A - 1, 2 * M), consts, 4, 1.0)
    assert torch.count_nonzero(aud) == 0 and torch.count_nonzero(tail) == 0
    assert not torch.signbit(aud).any()


def test_fm_chain_wrapper_rejects_what_it_does_not_take():
    M, L, A = 16, 8, 33
    consts = fm_chain.fm_chain_consts(np.ones((L, M), np.float32),
                                      np.ones(A, np.float32), "cpu")
    z = torch.zeros
    args = (z(256, 2 * M), z(8, 2 * M), z(1, 2 * M), z(A - 1, 2 * M), consts, 4, 1.0)
    with pytest.raises(ValueError, match="warm"):  # a halo of H8 rows only
        fm_chain.fm_chain_step_planes(*args, warm=256)
    with pytest.raises(ValueError, match="precision"):
        fm_chain.fm_chain_step_planes(*args, precision="bf16")
    with pytest.raises(ValueError, match="halo"):
        fm_chain.fm_chain_step_planes(args[0], z(16, 2 * M), *args[2:])
    with pytest.raises(ValueError, match="audio tail"):
        fm_chain.fm_chain_step_planes(z(16, 2 * M), *args[1:])
    for p in fm_chain.PRECISIONS:  # every tier computes the same FP32 chain
        fm_chain.fm_chain_step_planes(*args, precision=p)
    assert fm_chain.fm_chain_step_planes.launches == 0
