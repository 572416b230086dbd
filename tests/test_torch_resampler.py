"""The polyphase resampler (``ops/fir.py`` ``interp_taps``,
``fir_interp_filter``, the ``rational_resampler`` block) where an arm has
one tap, and the port's twins of the reference's property tests
(``tests/test_ops_property.py``: random FIR and PFB shapes), plus a random
resampler shape, on the CPU against the JAX package and scipy.

An arm has one tap where ceil(ntaps / interp) = 1. Its reversed numpy
view keeps a negative stride, which ``torch.tensor`` refuses, so the taps
are copied; these shapes hold the port to that. The reference's own
``fir_interp_filter`` fails at ntaps = 1 with interp > 1 (a broadcast
error), so there the port is held to scipy's ``upfirdn``.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from newsched_tpu.blocks import filter as jfilt, general as jgen
from newsched_tpu.ops import fir as jfir, pfb as jpfb
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch.blocks import filter as tfilt, general as tgen
from newsched_tpu_torch.ops import fir, pfb
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

# (ntaps, interp, decim) whose arms have one tap
ONE_TAP_ARMS = [(4, 6, 5), (3, 3, 3), (2, 2, 3), (2, 4, 3), (5, 5, 1)]
TOL = 1e-6  # float32 sums of <= 5 products of values ~1, two orders apart


def _taps(ntaps, seed=0):
    return np.random.default_rng(seed).standard_normal(ntaps).astype(
        np.float32) * 0.5


def _signal(n, seed, cplx=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + (1j * rng.standard_normal(n) if cplx else 0)
    return x.astype(np.complex64 if cplx else np.float32)


def _port_stream(taps, x, interp, decim, B, dev_taps=None):
    st_ = fir.resampler_init_state(len(taps), interp, "cpu",
                                   torch.from_numpy(x[:1]).dtype)
    outs = []
    for b in range(len(x) // B):
        st_, y = fir.fir_interp_filter(taps, st_,
                                       torch.from_numpy(x[b * B:(b + 1) * B]),
                                       interp, decim, dev_taps=dev_taps)
        outs.append(y.numpy())
    return np.concatenate(outs)


def _ref_stream(taps, x, interp, decim, B):
    st_ = jfir.resampler_init_state(len(taps), interp,
                                    jnp.asarray(x[:1]).dtype)
    outs = []
    for b in range(len(x) // B):
        st_, y = jfir.fir_interp_filter(taps, st_,
                                        jnp.asarray(x[b * B:(b + 1) * B]),
                                        interp, decim)
        outs.append(np.asarray(y))
    return np.concatenate(outs)


def _upfirdn(taps, x, interp, decim, n):
    """scipy's upfirdn of the whole stream, its first n outputs (past the
    signal's end the streaming filter has not yet seen its zeros)."""
    y = sig.upfirdn(taps.astype(np.float64), x.astype(np.complex128), interp,
                    decim)
    return y[:n]


@pytest.mark.parametrize("ntaps,interp,decim", ONE_TAP_ARMS)
def test_interp_taps_one_tap_arms(ntaps, interp, decim):
    """Every phase a contiguous copy, taps[l*interp + p] reversed, and as
    ``dev_taps`` the reference's outputs."""
    taps = _taps(ntaps)
    it = fir.interp_taps(taps, interp, decim, "cpu")
    L = -(-ntaps // interp)
    tpad = np.pad(taps, (0, L * interp - ntaps))
    for r, ph in enumerate(it.phases):
        assert ph.is_contiguous() and ph.dtype == torch.float32
        np.testing.assert_array_equal(
            ph.numpy(), tpad[(r * decim) % interp::interp][::-1])
    B = 48 * decim
    x = _signal(3 * B, 1)
    got = _port_stream(taps, x, interp, decim, B, dev_taps=it)
    np.testing.assert_allclose(got, _ref_stream(taps, x, interp, decim, B),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("cplx", [True, False])
@pytest.mark.parametrize("ntaps,interp,decim", ONE_TAP_ARMS)
def test_fir_interp_filter_one_tap_arms(ntaps, interp, decim, cplx):
    taps = _taps(ntaps, 2)
    B = 40 * decim
    x = _signal(3 * B, 3, cplx)
    got = _port_stream(taps, x, interp, decim, B)
    ref = _ref_stream(taps, x, interp, decim, B)
    assert got.shape == ref.shape == (3 * B * interp // decim,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _upfirdn(taps, x, interp, decim, len(got)),
                               rtol=0, atol=TOL)


def _block_run(pkg, interp, decim, taps, x, batch, dtype):
    filt, gen, Fg = (jfilt, jgen, JFlowgraph) if pkg == "jax" else \
        (tfilt, tgen, TFlowgraph)
    fg = Fg(batch_size=batch)
    blk = filt.rational_resampler(interp, decim, taps=taps, dtype=dtype)
    snk = gen.vector_sink(dtype=dtype)
    fg.connect(gen.vector_source(x), 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return np.asarray(snk.data())


@pytest.mark.parametrize("ntaps,interp,decim",
                         ONE_TAP_ARMS + [(2, 3, 2), (4, 4, 1)])
def test_rational_resampler_block_one_tap_arms(ntaps, interp, decim):
    """The block over three batches against the reference's block; (3, 2)
    with 2 taps and (4, 1) with 4 are the block shapes that raised."""
    taps = _taps(ntaps, 4)
    B = 60 * decim
    x = _signal(3 * B, 5)
    got = _block_run("torch", interp, decim, taps, x, B, "cf32")
    ref = _block_run("jax", interp, decim, taps, x, B, "cf32")
    assert got.shape == ref.shape == (3 * B * interp // decim,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("interp,decim", [(2, 1), (3, 2), (4, 3), (8, 5)])
def test_one_tap_resampler_matches_upfirdn(interp, decim):
    """ntaps = 1, where the reference's fir_interp_filter itself fails:
    the port's function and block against scipy's upfirdn."""
    taps = _taps(1, 6)
    B = 30 * decim
    x = _signal(3 * B, 7)
    got = _port_stream(taps, x, interp, decim, B)
    assert got.shape == (3 * B * interp // decim,)
    want = _upfirdn(taps, x, interp, decim, len(got))
    np.testing.assert_allclose(got[:len(want)], want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[len(want):], 0)
    blk = _block_run("torch", interp, decim, taps, x, B, "cf32")
    np.testing.assert_array_equal(blk, got)


@settings(max_examples=25, deadline=None)
@given(ntaps=st.integers(1, 24), interp=st.integers(1, 8),
       decim=st.integers(1, 8), n_batches=st.integers(1, 3),
       cplx=st.booleans(), seed=st.integers(0, 99))
def test_resampler_random_shape(ntaps, interp, decim, n_batches, cplx, seed):
    """Random resampler shapes, streamed over random batch counts, against
    scipy's upfirdn, and the reference's where it runs (not at ntaps = 1
    with interp > 1)."""
    taps = _taps(ntaps, seed)
    B = 16 * decim
    x = _signal(n_batches * B, seed + 1, cplx)
    got = _port_stream(taps, x, interp, decim, B)
    assert got.shape == (n_batches * B * interp // decim,)
    want = _upfirdn(taps, x, interp, decim, len(got))
    np.testing.assert_allclose(got[:len(want)], want, rtol=0, atol=5e-6)
    if ntaps > 1 or interp == 1:
        np.testing.assert_allclose(got, _ref_stream(taps, x, interp, decim, B),
                                   rtol=0, atol=5e-6)


def _snr(ref, got):
    ref = np.asarray(ref).ravel()
    err = ref - np.asarray(got).ravel().astype(ref.dtype)
    e = float(np.mean(np.abs(err) ** 2))
    p = float(np.mean(np.abs(ref) ** 2))
    return np.inf if e == 0 else 10 * np.log10(max(p, 1e-300) / e)


@settings(max_examples=25, deadline=None)
@given(ntaps=st.integers(1, 96), decim=st.integers(1, 12),
       n_batches=st.integers(1, 3), method=st.sampled_from(["conv", "mxu",
                                                            "fft"]),
       seed=st.integers(0, 99))
def test_fir_random_config_matches_reference(ntaps, decim, n_batches, method,
                                             seed):
    """Twin of the reference's random FIR property test: the port's
    ``fir_filter`` by each method against scipy (> 80 dB, as there) and
    against the reference's by the same method."""
    rng = np.random.default_rng(seed)
    taps = rng.standard_normal(ntaps).astype(np.float32) * 0.3
    B = 256 * decim
    x = (rng.standard_normal(B * n_batches)
         + 1j * rng.standard_normal(B * n_batches)).astype(np.complex64)
    tst = fir.fir_init_state(ntaps, "cpu")
    jst = jfir.fir_init_state(ntaps, dtype=jnp.complex64)
    got, ref = [], []
    for b in range(n_batches):
        xb = x[b * B:(b + 1) * B]
        tst, y = fir.fir_filter(taps, tst, torch.from_numpy(xb), decim=decim,
                                method=method)
        jst, jy = jfir.fir_filter(taps, jst, jnp.asarray(xb), decim=decim,
                                  method=method)
        got.append(y.numpy())
        ref.append(np.asarray(jy))
    got, ref = np.concatenate(got), np.concatenate(ref)
    gold = sig.lfilter(taps.astype(np.float64), [1.0],
                       x.astype(np.complex128))[::decim]
    assert got.shape == ref.shape == gold.shape
    assert _snr(gold, got) > 80, (ntaps, decim, method, _snr(gold, got))
    assert _snr(ref, got) > 80, (ntaps, decim, method, _snr(ref, got))


@settings(max_examples=10, deadline=None)
@given(log2_m=st.integers(2, 5), taps_per_arm=st.integers(2, 12),
       n_batches=st.integers(1, 3), seed=st.integers(0, 99))
def test_pfb_random_config_matches_reference(log2_m, taps_per_arm, n_batches,
                                             seed):
    """Twin of the reference's random PFB property test: the port's
    ``pfb_channelize`` ("sum") streamed over random batch splits against
    the reference's and a float64 numpy polyphase model (> 80 dB)."""
    M = 1 << log2_m
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal(M * taps_per_arm).astype(np.float32) * 0.2
    arm = pfb.pfb_arm_taps(proto, M)
    L = arm.shape[1]
    B = 64 * M
    x = (rng.standard_normal(B * n_batches)
         + 1j * rng.standard_normal(B * n_batches)).astype(np.complex64)
    tst = pfb.pfb_init_state(arm.size, "cpu")
    jst = jpfb.pfb_init_state(arm.size, dtype=jnp.complex64)
    got, ref = [], []
    for k in range(n_batches):
        xb = x[k * B:(k + 1) * B]
        tst, Y = pfb.pfb_channelize(arm, tst, torch.from_numpy(xb),
                                    method="sum")
        jst, jY = jpfb.pfb_channelize(jnp.asarray(arm), jst, jnp.asarray(xb),
                                      method="sum")
        got.append(Y.numpy())
        ref.append(np.asarray(jY))
    got, ref = np.concatenate(got), np.concatenate(ref)
    arm64 = pfb.pfb_arm_taps(proto.astype(np.float64), M)
    n_out = len(x) // M
    xfull = np.concatenate([np.zeros(M * L - 1, np.complex128),
                            x.astype(np.complex128)])
    need = L - 1 + n_out
    V = xfull[: need * M].reshape(need, M)[:, ::-1].T
    filt = np.empty((M, n_out), np.complex128)
    for pp in range(M):
        filt[pp] = np.correlate(V[pp], arm64[pp][::-1], mode="valid")[:n_out]
    gold = (M * np.fft.ifft(filt, axis=0)).T
    assert got.shape == ref.shape == gold.shape
    assert _snr(gold, got) > 80, (M, taps_per_arm, _snr(gold, got))
    assert _snr(ref, got) > 80, (M, taps_per_arm, _snr(ref, got))
