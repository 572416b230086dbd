"""The live flagship slice on the CPU: ``fm_chain_gen_step`` (kernel K5,
plain version) against the noise stream fed to the fused chain, against
the JAX package's fused chain (Pallas in interpret mode) on the same rows,
the live model ``fm_channelizer(fused=True, source="live")`` against the
fused model with its default noise source, and the two-draw noise stream.
CUDA is never built here: every launch count stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.blocks import vector_dsp as jvd
from newsched_tpu.ops import firdes, pfb as jpfb
from newsched_tpu.ops.pallas import fm_chain as jfm

from newsched_tpu_torch import convert, models as tmodels
from newsched_tpu_torch.blocks import vector_dsp as tvd
from newsched_tpu_torch.ops.cuda import fm_chain, noise

GAIN = 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(M=64, L=16, A=65, decim=8):
    taps = firdes.prototype_channelizer_taps(M, L)
    ataps = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    return fold_c, ataps


def _zeros(M, H8, A):
    return (torch.zeros(H8, 2 * M), torch.zeros(1, 2 * M),
            torch.zeros(A - 1, 2 * M))


# (hi, lo) of the first batch: the second starts at lo = -2 + 4 groups,
# so the first batch's group counter wraps lo into hi inside the batch
_START = (0, -2)


@pytest.mark.parametrize("draws", [3, 2])
def test_gen_step_equals_noise_rows_through_the_chain(draws):
    """Three batches: K5's plain version is bit for bit the noise stream x
    amp fed to K3's plain version, carry included, across a wrap of the
    group counter's low word."""
    M, A, decim, n = 64, 65, 8, 256
    fold_c, ataps = _chain(M, A=A, decim=decim)
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    H8 = fm_chain._round8(fold_c.shape[0] - 1)
    amp = torch.tensor(0.5)
    hi, lo = _START
    carry, prev, tail = _zeros(M, H8, A)
    halo, prev_r, tail_r = _zeros(M, H8, A)
    for _ in range(3):
        aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
            noise.group64(hi, lo), amp, carry, prev, tail, consts, decim, GAIN, n, seed=4,
            draws=draws)
        rows = noise.gaussian_rows_plain(noise.group64(hi, lo), n_rows=n, width=2 * M, seed=4,
                                         device="cpu", draws=draws) * amp
        aud_r, prev_r, tail_r = fm_chain.fm_chain_step_planes_plain(
            rows, halo, prev_r, tail_r, consts, decim, GAIN)
        halo = rows[-H8:]
        for got, ref in ((aud, aud_r), (prev, prev_r), (tail, tail_r),
                         (carry, halo)):
            assert torch.equal(got, ref)
        hi, lo = noise.advance_groups(hi, lo, n // noise.GROUP_ROWS)
    assert (hi, lo) == (1, 10)
    assert fm_chain.fm_chain_gen_step.launches == 0


@pytest.mark.parametrize("draws", [3, 2])
def test_gen_step_matches_pallas_chain_on_the_same_rows(draws):
    """The generated rows through the JAX package's fused chain (interpret
    mode, HIGHEST) agree with K5's plain version within the tolerance of
    test_fm_chain_plain_matches_pallas_highest."""
    M, A, decim, n = 64, 65, 8, 256
    fold_c, ataps = _chain(M, A=A, decim=decim)
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    H8 = fm_chain._round8(fold_c.shape[0] - 1)
    carry, prev, tail = _zeros(M, H8, A)
    jhalo = np.zeros((H8, 2 * M), np.float32)
    jprev = jnp.zeros((1, 2 * M), jnp.float32)
    jtail = jnp.zeros((A - 1, 2 * M), jnp.float32)
    hi, lo = _START
    for b in range(3):
        aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
            noise.group64(hi, lo), 0.5, carry, prev, tail, consts, decim, GAIN, n, draws=draws)
        rows = (noise.gaussian_rows_plain(noise.group64(hi, lo), n_rows=n, width=2 * M, seed=0,
                                          device="cpu", draws=draws)
                * torch.tensor(0.5)).numpy()
        jaud, jprev, jtail = jfm.fm_chain_step_planes(
            jnp.asarray(rows), jnp.asarray(jhalo), jprev, jtail, fold_c, ataps,
            decim, GAIN, tile=128, interpret=True,
            precision=jax.lax.Precision.HIGHEST)
        jhalo = rows[-H8:]
        for name, x, y in (("audio", aud, jaud), ("prev", prev, jprev),
                           ("tail", tail, jtail)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{name} batch {b}")
        hi, lo = noise.advance_groups(hi, lo, n // noise.GROUP_ROWS)


def _model(M, L, A, decim, rows, nb, **kw):
    at = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fg, blks = tmodels.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, fused=True,
        batch_size=rows * M, sink="vector", n_samples=nb * rows // decim,
        deviation_frac=1.0 / (2 * np.pi * 0.5), audio_taps=at, **kw)
    fg.run(device="cpu")
    return blks, blks["sink"].data()


def test_live_model_equals_fused_model_with_noise_source():
    M, L, A, decim, rows, nb = 64, 16, 65, 8, 256, 3
    live, got = _model(M, L, A, decim, rows, nb, source="live", noise_draws=3)
    assert isinstance(live["source"], tvd.fm_noise_channelizer_source)
    fused, ref = _model(M, L, A, decim, rows, nb)
    assert isinstance(fused["source"], tvd.noise_planes_source)
    assert got.shape == ref.shape == (nb * rows // decim, M)
    np.testing.assert_array_equal(got, ref)
    assert fm_chain.fm_chain_gen_step.launches == 0


def test_live_model_two_draws_equals_its_stream_through_the_chain():
    M, L, A, decim, rows, nb = 64, 16, 65, 8, 256, 3
    _, got = _model(M, L, A, decim, rows, nb, source="live", noise_draws=2)
    fold_c, ataps = _chain(M, L, A, decim)
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    H8 = fm_chain._round8(L - 1)
    halo, prev, tail = _zeros(M, H8, A)
    outs = []
    for b in range(nb):
        hi, lo = noise.advance_groups(0, 0, b * rows // noise.GROUP_ROWS)
        vb = noise.gaussian_rows_plain(noise.group64(hi, lo), n_rows=rows, width=2 * M, seed=0,
                                       device="cpu", draws=2) * torch.tensor(0.5)
        aud, prev, tail = fm_chain.fm_chain_step_planes_plain(
            vb, halo, prev, tail, consts, decim, 0.5)
        halo = vb[-H8:]
        outs.append(aud.numpy())
    np.testing.assert_array_equal(got, np.concatenate(outs))
    _, three = _model(M, L, A, decim, rows, nb, source="live", noise_draws=3)
    assert not np.array_equal(got, three)


def test_noise_two_draws_moments():
    """Irwin-Hall N=4: support +-3.46 sigma, excess kurtosis -0.3; a
    different stream from the three-draw one at the same seed."""
    r = noise.gaussian_rows(0, n_rows=8192, width=128, seed=5, device="cpu",
                            draws=2).double().numpy()
    n = r.size
    assert abs(r.mean()) < 5 / np.sqrt(n)
    assert abs(r.std() - 1.0) < 0.01
    assert 3.3 < np.abs(r).max() <= 3.47
    kurt = np.mean(r**4) / np.mean(r**2) ** 2 - 3.0
    assert abs(kurt - (-0.3)) < 0.05
    three = noise.gaussian_rows(0, n_rows=64, width=128, seed=5, device="cpu")
    assert not np.array_equal(three.numpy(), r[:64])
    with pytest.raises(ValueError, match="draws"):
        noise.gaussian_rows(0, n_rows=64, width=128, seed=5, device="cpu",
                            draws=4)
    assert noise.gaussian_rows.launches == 0


def test_live_source_rejects_what_it_does_not_take():
    M, A = 64, 65
    fold_c, ataps = _chain(M, A=A)
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    carry, prev, tail = _zeros(M, 16, A)  # H8 = round8(L - 1), L = 16
    with pytest.raises(ValueError, match="carry rows"):
        fm_chain.fm_chain_gen_step(0, 0.5, carry[:4], prev, tail, consts, 8,
                                   GAIN, 256)
    with pytest.raises(ValueError, match="draws"):
        fm_chain.fm_chain_gen_step(0, 0.5, carry, prev, tail, consts, 8,
                                   GAIN, 256, draws=1)
    with pytest.raises(ValueError, match="H8"):
        fm_chain.fm_chain_gen_step(0, 0.5, carry, prev, tail, consts, 8,
                                   GAIN, 256, tile=8)
    # a tile shorter than the audio FIR's A-1 rows of history is taken
    short = fm_chain.fm_chain_gen_step(0, 0.5, carry, prev, tail, consts, 8,
                                       GAIN, 256, tile=32)
    whole = fm_chain.fm_chain_gen_step(0, 0.5, carry, prev, tail, consts, 8,
                                       GAIN, 256)
    for a, b in zip(short, whole):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise_draws"):
        tvd.fm_noise_channelizer_source(M, None, ataps, noise_draws=4)
    with pytest.raises(ValueError, match="generator"):
        tvd.fm_noise_channelizer_source(M, None, ataps, generator="threefry")
    blk = tvd.fm_noise_channelizer_source(M, None, ataps)
    with pytest.raises(ValueError, match="multiples of 64"):
        blk.init_state(0, 4, "cpu")  # 4 audio rows = 32 stream rows


def test_live_source_state_from_jax_maps_key_by_key():
    """The reference live source's state (its 64-bit group counter as an
    int32 pair, and the chain's carries) becomes the port's on-card forms:
    one int64 counter and the carries, all tensors; one step from it runs
    and advances the counter on the device."""
    M, A = 64, 65
    fold_c, ataps = _chain(M, A=A)
    jblk = jvd.fm_noise_channelizer_source(M, None, ataps, audio_decim=8,
                                           interpret=True)
    jst = jblk.init_state(0, 32)
    jst = dict(jst, ghi=jnp.int32(2), glo=jnp.int32(-3))
    st = convert.state_from_jax(jax.device_get(jst), "cpu")
    assert "ghi" not in st and "glo" not in st
    assert st["group"].dtype == torch.int64 and st["group"].shape == ()
    assert int(st["group"]) == noise.group64(2, -3)
    for k, shape in (("carry", (16, 2 * M)), ("prev", (1, 2 * M)),
                     ("atail", (A - 1, 2 * M))):
        assert st[k].shape == shape and st[k].dtype == torch.float32
    blk = tvd.fm_noise_channelizer_source(M, None, ataps, audio_decim=8)
    st2, out = blk.work(st, {}, blk.param_leaves("cpu"), 32)
    assert out["out"].shape == (32, M)
    assert int(st2["group"]) == noise.group64(*noise.advance_groups(2, -3, 4))
