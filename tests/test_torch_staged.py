"""The staged flagship slice on the CPU: the channelizer front end (K7
``arm_fold`` and K1 ``arm_fold_dft``, plain versions), ``pfb_channelize``
/ ``pfb_decimate``, ``fir_filter``, ``noise_source`` and the staged
``models.fm_channelizer()`` held against the JAX package on the same numpy
inputs (Pallas in interpret mode), against the float64 golden, and across a
hand-over of the staged states at a batch boundary. CUDA is never built
here: every launch count stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu import models as jmodels
from newsched_tpu.blocks import filter as jfilt, general as jgen, vector_dsp as jvd
from newsched_tpu.ops import fir as jfir, firdes, pfb as jpfb
from newsched_tpu.ops.pallas import channelizer as jch
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import convert, models as tmodels, testing
from newsched_tpu_torch.blocks import analog as tanalog, filter as tfilt, \
    general as tgen, vector_dsp as tvd
from newsched_tpu_torch.ops import fir, pfb
from newsched_tpu_torch.ops.cuda import channelizer, noise
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

GAIN = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cf32(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * scale
            ).astype(np.complex64)


def _fold_case(M, L, n_out, seed):
    """Interleaved commutator rows and fold taps of a real channelizer."""
    taps = firdes.prototype_channelizer_taps(M, L)
    c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    V = _cf32((n_out + L - 1) * M, seed).reshape(n_out + L - 1, M)
    v = np.array(jch.complex_to_interleaved(jnp.asarray(V)))  # writable
    return V, v, c


def test_interleaved_helpers_match_reference_and_are_views():
    V, v, c = _fold_case(64, 8, 40, seed=1)
    tV = torch.from_numpy(V)
    tv = channelizer.complex_to_interleaved(tV)
    np.testing.assert_array_equal(tv.numpy(), v)
    assert tv.data_ptr() == tV.data_ptr()  # no copy
    back = channelizer.interleaved_to_complex(tv)
    assert back.data_ptr() == tv.data_ptr()
    np.testing.assert_array_equal(back.numpy(), V)
    np.testing.assert_array_equal(channelizer.interleave_taps(c), jch.interleave_taps(c))
    for M in (16, 64):
        np.testing.assert_array_equal(channelizer.interleaved_dft_matrix(M),
                                      jch.interleaved_dft_matrix(M))


@pytest.mark.parametrize("tile", [128, 256])
def test_arm_fold_plain_matches_pallas(tile):
    """K7's plain version against the TPU kernel in interpret mode, fed the
    exact rows it needs (the port's wrapper) and n_out + H8 rows (the
    reference pads its input to that)."""
    M, L, n_out = 64, 16, 512
    V, v, c = _fold_case(M, L, n_out, seed=tile)
    c2 = channelizer.interleave_taps(c)
    ref = np.asarray(jch.arm_fold(jnp.asarray(v), c2, n_out, tile=tile,
                                  interpret=True))
    got = channelizer.arm_fold(torch.from_numpy(v), c2, n_out, tile=tile)
    assert got.shape == (n_out, 2 * M)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), channelizer.arm_fold(
        torch.from_numpy(v), c2, n_out, tile=64).numpy())
    acc = channelizer.pfb_arm_fold_complex(torch.from_numpy(V), c, n_out, tile=tile)
    ref_c = np.asarray(jch.pfb_arm_fold_complex(jnp.asarray(V), c, n_out,
                                                tile=tile, interpret=True))
    np.testing.assert_allclose(acc.numpy(), ref_c, rtol=1e-6, atol=1e-6)
    assert channelizer.arm_fold.launches == 0


@pytest.mark.parametrize("M, L, short", [
    (64, 1, 0), (64, 4, 0), (64, 16, 0), (64, 17, 0),  # the tap counts
    (64, 16, 5), (48, 17, 9),                          # v short of its rows
    (48, 16, 0), (17, 16, 0), (17, 4, 3)])             # W = 96 and W = 34
def test_arm_fold_plain_matches_pallas_at_any_taps_and_width(M, L, short):
    """K7's plain version against the TPU kernel in interpret mode at tap
    counts with and without a templated instance (4, 16 and 1, 17), at
    widths 2M = 96 and 34 (not multiples of 128, nor 34 of 4), and with v
    ``short`` rows short of n_out + L - 1: the missing rows read as 0, as
    the reference's padding gives."""
    n_out = 96
    V, v, c = _fold_case(M, L, n_out, seed=10 * L + M)
    v = v[:v.shape[0] - short]
    c2 = channelizer.interleave_taps(c)
    ref = np.asarray(jch.arm_fold(jnp.asarray(v), c2, n_out, tile=32,
                                  interpret=True))
    got = channelizer.arm_fold(torch.from_numpy(v), c2, n_out)
    assert got.shape == (n_out, 2 * M)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    if short:
        np.testing.assert_array_equal(got.numpy(), channelizer.arm_fold(
            torch.from_numpy(np.pad(v, ((0, short), (0, 0)))), c2,
            n_out).numpy())
    assert channelizer.arm_fold.launches == 0


@pytest.mark.parametrize("tile", [128, 256])
def test_arm_fold_dft_plain_matches_pallas(tile):
    M, L, n_out = 64, 16, 512
    V, v, c = _fold_case(M, L, n_out, seed=3 + tile)
    c2 = channelizer.interleave_taps(c)
    w2 = channelizer.interleaved_dft_matrix(M)
    ref = np.asarray(jch.arm_fold_dft(jnp.asarray(v), c2, w2, n_out, tile=tile,
                                      interpret=True))
    got = channelizer.arm_fold_dft(torch.from_numpy(v), c2, w2, n_out, tile=tile)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    Y = channelizer.pfb_channelize_fused(torch.from_numpy(V), c, n_out, tile=tile)
    ref_c = np.asarray(jch.pfb_channelize_fused(jnp.asarray(V), c, n_out,
                                                tile=tile, interpret=True))
    np.testing.assert_allclose(Y.numpy(), ref_c, rtol=1e-5, atol=1e-5)
    # rows past the end of v read as 0, as the reference's padding gives
    short = channelizer.arm_fold_dft(torch.from_numpy(v[:-5]), c2, w2, n_out)
    ref_s = np.asarray(jch.arm_fold_dft(jnp.asarray(v[:-5]), c2, w2, n_out,
                                        tile=tile, interpret=True))
    np.testing.assert_allclose(short.numpy(), ref_s, rtol=1e-5, atol=1e-5)
    assert channelizer.arm_fold_dft.launches == 0


def _pfb_batches(M, L, n_out, nb, seed):
    taps = firdes.prototype_channelizer_taps(M, L)
    return jpfb.pfb_arm_taps(taps, M), [_cf32(n_out * M, seed + b) for b in range(nb)]


@pytest.mark.parametrize("combine", ["fft", "matmul"])
@pytest.mark.parametrize("method", ["auto", "fused", "pallas", "sum"])
def test_pfb_channelize_matches_reference(method, combine):
    """Three batches with carried state, every method of the port against
    the reference's "sum" path with the same combine (its "pallas" and
    "fused" methods need a TPU; the kernels' plain versions are held
    against them in interpret mode above)."""
    M, L, n_out = 64, 8, 96
    arm, xs = _pfb_batches(M, L, n_out, 3, seed=7)
    jst = jpfb.pfb_init_state(M * L)
    tst = pfb.pfb_init_state(M * L, "cpu")
    for x in xs:
        jst, Yr = jpfb.pfb_channelize(arm, jst, jnp.asarray(x), method="sum",
                                      combine=combine)
        tst, Y = pfb.pfb_channelize(arm, tst, torch.from_numpy(x),
                                    method=method, combine=combine)
        ref = np.asarray(Yr)
        assert Y.shape == ref.shape and Y.dtype == torch.complex64
        assert np.abs(Y.numpy() - ref).max() / np.abs(ref).max() < 2e-6
        np.testing.assert_array_equal(tst.tail.numpy(), np.asarray(jst.tail))
    with pytest.raises(ValueError, match="method"):
        pfb.pfb_channelize(arm, tst, torch.from_numpy(xs[0]), method="mxu")
    with pytest.raises(ValueError, match="divisible"):
        pfb.pfb_channelize(arm, tst, torch.from_numpy(xs[0][:-1]))


@pytest.mark.parametrize("M,want", [(64, "fused"), (128, "fused"), (192, "fused"),
                                    (256, "fused"), (48, "pallas"), (16, "pallas"),
                                    (32, "pallas"), (320, "fused"),
                                    (512, "fused"), (576, "pallas"),
                                    (704, "pallas")])
def test_pfb_channelize_auto_follows_reference_rule(M, want, monkeypatch):
    """"auto" takes K1 where the reference's rule does and K1 has its planes
    FFT (M = 64 P) up to ``pfb.AUTO_K1_MAX`` = 512 (P = 1 .. 8), and K7
    and the combine at every other width (the reference's "sum" there, or
    K1's widths past 512, where K7 and cuFFT's combine was the faster on
    the card), never the plain path
    because of the width; the result matches the reference's "sum" within
    2e-6 of max|Y|."""
    taken = []
    for name in ("arm_fold_dft", "arm_fold"):
        real = getattr(channelizer, name)
        monkeypatch.setattr(channelizer, name,
                            lambda *a, _f=real, _n=name, **k: (taken.append(_n), _f(*a, **k))[1])
    L, n_out = 4, 8
    arm, (x,) = _pfb_batches(M, L, n_out, 1, seed=M)
    _, Y = pfb.pfb_channelize(arm, pfb.pfb_init_state(M * L, "cpu"), torch.from_numpy(x))
    _, ref = jpfb.pfb_channelize(arm, jpfb.pfb_init_state(M * L), jnp.asarray(x),
                                 method="sum")
    assert taken == (["arm_fold_dft"] if want == "fused" else ["arm_fold"])
    assert np.abs(Y.numpy() - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max() < 2e-6


def test_arm_fold_dft_refuses_a_width_its_kernel_does_not_take():
    """On a CUDA tensor the wrapper launches or raises naming the width;
    this CPU check fakes the device so the width check is reached."""
    class FakeCuda:
        device = torch.device("cuda", 0)
        shape = (10, 96)

    with pytest.raises(ValueError, match="width 96 lanes"):
        channelizer.arm_fold_dft(FakeCuda(), np.zeros((4, 96)), np.zeros((96, 96)), 4)


@pytest.mark.parametrize("channel", [0, 5, 63])
def test_pfb_decimate_matches_reference_and_channelizer(channel):
    M, L, n_out = 64, 8, 96
    arm, xs = _pfb_batches(M, L, n_out, 2, seed=11)
    jst = jpfb.pfb_init_state(M * L)
    tst = tsum = tch = pfb.pfb_init_state(M * L, "cpu")
    for x in xs:
        tx = torch.from_numpy(x)
        jst, yr = jpfb.pfb_decimate(arm, jst, jnp.asarray(x), channel)
        tst, y = pfb.pfb_decimate(arm, tst, tx, channel)
        tsum, ys = pfb.pfb_decimate(arm, tsum, tx, channel, method="sum")
        tch, Y = pfb.pfb_channelize(arm, tch, tx)
        ref = np.asarray(yr)
        scale = np.abs(ref).max()
        assert y.shape == (n_out,)
        assert np.abs(y.numpy() - ref).max() / scale < 2e-6
        assert np.abs(ys.numpy() - ref).max() / scale < 2e-6
        sel = tvd.channel_select(M, channel).work((), {"in": Y}, {}, n_out)[1]["out"]
        assert np.abs(y.numpy() - sel.numpy()).max() / scale < 2e-6
        np.testing.assert_array_equal(tst.tail.numpy(), np.asarray(jst.tail))
    assert channelizer.arm_fold.launches == 0


def _fir_case(kind, ntaps, seed):
    rng = np.random.default_rng(seed)
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=ntaps)
    if kind == "cc":
        taps = (taps * np.exp(1j * 0.3 * np.arange(ntaps))).astype(np.complex64)
    cplx = kind != "rf32"
    dt = np.complex64 if cplx else np.float32

    def batch(n):
        x = rng.standard_normal((3, n))
        if cplx:
            x = x + 1j * rng.standard_normal((3, n))
        return x.astype(dt)

    return taps, dt, batch


@pytest.mark.parametrize("decim", [1, 4, 8])
@pytest.mark.parametrize("kind", ["rf32", "cf32", "cc"])
@pytest.mark.parametrize("method", ["mxu", "conv"])
def test_fir_filter_matches_reference(method, kind, decim):
    """Three channels filtered in one batched call, two batches with
    carried state, against the reference's filter on each channel."""
    ntaps = 65
    taps, dt, batch = _fir_case(kind, ntaps, seed=decim)
    jtails = [jfir.fir_init_state(ntaps, dtype=dt) for _ in range(3)]
    tst = fir.fir_init_state(ntaps, "cpu", torch.from_numpy(np.zeros(0, dt)).dtype, (3,))
    for n in (256, 512):
        x = batch(n)
        tst, y = fir.fir_filter(taps, tst, torch.from_numpy(x), decim=decim,
                                method=method)
        assert y.shape == (3, n // decim)
        for ch in range(3):
            jtails[ch], yr = jfir.fir_filter(taps, jtails[ch], jnp.asarray(x[ch]),
                                             decim=decim, method=method)
            np.testing.assert_allclose(y[ch].numpy(), np.asarray(yr),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(tst.tail[ch].numpy(),
                                          np.asarray(jtails[ch].tail))


def test_fir_filter_auto_choice_follows_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    tx = torch.from_numpy(x)
    st = fir.fir_init_state(65, "cpu", torch.float32, (2,))
    taps = firdes.low_pass(1.0, 1.0, 0.05, 0.0125, ntaps=65)

    def run(t, decim, method):
        return fir.fir_filter(t, st, tx, decim=decim, method=method)[1]

    # host taps, decim <= max(4, ntaps // 8): the Toeplitz path
    assert torch.equal(run(taps, 8, "auto"), run(taps, 8, "mxu"))
    # past that, or with tensor taps: the windowed correlation
    assert torch.equal(run(taps, 16, "auto"), run(taps, 16, "conv"))
    assert torch.equal(run(torch.from_numpy(taps), 8, "auto"), run(taps, 8, "conv"))
    for decim in (1, 8, 16):
        ref = [np.asarray(jfir.fir_filter(taps, jfir.fir_init_state(65, jnp.float32),
                                          jnp.asarray(x[c]), decim=decim)[1])
               for c in range(2)]
        np.testing.assert_allclose(run(taps, decim, "auto").numpy(), np.stack(ref),
                                   rtol=1e-5, atol=1e-5)
    # past 384 taps the reference picks "fft", and so does the port
    t400 = np.hanning(400).astype(np.float32)
    st400 = fir.fir_init_state(400, "cpu", torch.float32, (2,))
    y400 = fir.fir_filter(t400, st400, tx)[1]
    ref = np.stack([np.asarray(jfir.fir_filter(
        t400, jfir.fir_init_state(400, jnp.float32), jnp.asarray(x[c]))[1])
        for c in range(2)])
    np.testing.assert_allclose(y400.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    assert torch.equal(y400, fir.fir_filter(t400, st400, tx, method="fft")[1])
    # the reference's bf16x3 Toeplitz tier is the FP32 Toeplitz path here
    assert torch.equal(run(taps, 1, "mxu3"), run(taps, 1, "mxu"))
    with pytest.raises(ValueError, match="unknown FIR method"):
        run(taps, 1, "direct")
    with pytest.raises(ValueError, match="divisible"):
        run(taps, 3, "auto")


@pytest.mark.parametrize("dtype", ["cf32", "rf32"])
def test_noise_source_equals_gaussian_rows(dtype):
    """Two batches of the block: cf32 takes each 128-word row's halves as
    real and imaginary parts, rf32 the rows in order; x amplitude."""
    blk = tanalog.noise_source("gaussian", amplitude=0.5, seed=3, dtype=dtype)
    nout = 8192 if dtype == "rf32" else 4096 * 3
    st = blk.init_state(0, nout, "cpu")
    params = blk.param_leaves("cpu")
    outs = []
    for _ in range(2):
        st, o = blk.work(st, {}, params, nout)
        outs.append(o["out"])
    got = torch.cat(outs)
    n_rows = 2 * nout * (2 if dtype == "cf32" else 1) // 128
    r = noise.gaussian_rows_plain(0, n_rows=n_rows, width=128, seed=3,
                                  device="cpu")
    half = torch.tensor(0.5)
    if dtype == "cf32":
        assert got.dtype == torch.complex64
        assert torch.equal(got.real, r[:, :64].reshape(-1) * half)
        assert torch.equal(got.imag, r[:, 64:].reshape(-1) * half)
    else:
        assert torch.equal(got, r.reshape(-1) * half)
    assert st["group"].dtype == torch.int64
    assert int(st["group"]) == n_rows // noise.GROUP_ROWS
    with pytest.raises(ValueError, match="8192"):
        blk.init_state(0, nout + 64, "cpu")
    assert noise.gaussian_rows.launches == 0


def _staged_run(pkg, x, M, L, A, decim, rows):
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
    fg, blks = models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, source=gen.vector_source(x),
        batch_size=rows * M, sink="vector",
        deviation_frac=1.0 / (2 * np.pi * GAIN), audio_taps=at)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return blks["sink"].data(), taps, at


@pytest.mark.parametrize("M,L,A,decim,rows,nb", [(64, 16, 65, 8, 256, 3),
                                                 (64, 8, 33, 4, 128, 2)])
def test_staged_model_matches_reference_and_golden(M, L, A, decim, rows, nb):
    """fm_channelizer() with its defaults (staged) on a cf32 vector source:
    within the JAX package's staged-vs-fused bound (5e-4) of its staged
    model outside the branch-cut mask, and >= 60 dB against the golden."""
    x = _cf32(nb * rows * M, seed=M + L)
    got, taps, at = _staged_run("torch", x, M, L, A, decim, rows)
    ref, _, _ = _staged_run("jax", x, M, L, A, decim, rows)
    gold, bad = testing.rows_reference(testing.planes_rows(x, M), taps, at,
                                       nchans=M, audio_decim=decim,
                                       demod_gain=GAIN, return_risk=True)
    assert got.shape == ref.shape == gold.shape == (nb * rows // decim, M)
    assert np.abs(got - ref)[~bad].max() <= 5e-4
    assert testing.snr_db(gold[~bad], got[~bad]) >= 60.0
    assert testing.snr_db(gold[~bad], ref[~bad]) >= 60.0
    assert channelizer.arm_fold_dft.launches == 0


def test_staged_model_default_noise_source_against_golden():
    """No source: the staged model's noise_source stream, regenerated by
    the plain generator (rows of 128 words, halves as re/im, x 0.5),
    through the golden."""
    M, L, A, decim, rows, nb = 64, 16, 65, 8, 256, 2
    at = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fg, blks = tmodels.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, batch_size=rows * M,
        sink="vector", n_samples=nb * rows // decim,
        deviation_frac=1.0 / (2 * np.pi * GAIN), audio_taps=at)
    assert isinstance(blks["source"], tanalog.noise_source)
    fg.run(device="cpu")
    r = noise.gaussian_rows_plain(0, n_rows=nb * rows * M * 2 // 128,
                                  width=128, seed=0, device="cpu")
    x = (torch.complex(r[:, :64].reshape(-1), r[:, 64:].reshape(-1)) * 0.5).numpy()
    gold, bad = testing.rows_reference(testing.planes_rows(x, M),
                                       firdes.prototype_channelizer_taps(M, L),
                                       at, nchans=M, audio_decim=decim,
                                       demod_gain=GAIN, return_risk=True)
    got = blks["sink"].data()
    assert got.shape == gold.shape
    assert testing.snr_db(gold[~bad], got[~bad]) >= 60.0


def _staged_graph(pkg, x, M, L, A, decim):
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    gen, filt, vd, Fg = ((jgen, jfilt, jvd, JFlowgraph) if pkg == "jax"
                         else (tgen, tfilt, tvd, TFlowgraph))
    fg = Fg()
    blocks = [gen.vector_source(x, name="src"),
              filt.pfb_channelizer(M, taps=taps, name="pfb"),
              vd.vector_quad_demod(M, gain=GAIN, name="demod"),
              vd.vector_fir(M, at, decim=decim, dtype="rf32", name="audio"),
              gen.vector_sink(dtype="rf32", vlen=(M,), name="snk")]
    for a, b in zip(blocks, blocks[1:]):
        fg.connect(a, 0, b, 0)
    return fg, taps, at


def test_staged_states_from_jax_hand_over_at_batch_two():
    """JAX runs batch 1 of the staged graph; its states (source position,
    PfbState tail, demod prev, FirState tails) are converted; the port's
    batch 2 equals JAX's outside the branch-cut mask."""
    M, L, A, decim, rows = 64, 16, 65, 8, 256
    x = _cf32(2 * rows * M, seed=21)
    jfg, taps, at = _staged_graph("jax", x, M, L, A, decim)
    tfg, _, _ = _staged_graph("torch", x, M, L, A, decim)
    jcfg = jcompile(jfg, batch_size=rows * M)
    tcfg = tcompile(tfg, batch_size=rows * M)
    jstep = jax.jit(jcfg.step)
    jparams = jcfg.init_params()
    s1, _ = jstep(jcfg.init_states(), jparams)
    _, out2 = jstep(s1, jparams)
    states = convert.states_from_jax(jax.device_get(s1), "cpu")
    assert isinstance(states["pfb"], pfb.PfbState)
    assert states["pfb"].tail.shape == (M * L - 1,)
    assert isinstance(states["audio"], fir.FirState)
    assert states["audio"].tail.shape == (M, A - 1)
    assert states["demod"]["prev"].dtype == torch.complex64
    _, tout = tcfg.step(states, convert.params_from_jax(jparams, "cpu"))
    got, ref = tout["snk"].numpy(), np.asarray(out2["snk"])
    _, bad = testing.rows_reference(testing.planes_rows(x, M), taps, at,
                                    nchans=M, audio_decim=decim,
                                    demod_gain=GAIN, return_risk=True)
    keep = ~bad[rows // decim:]
    assert np.abs(got - ref)[keep].max() <= 5e-4
    assert np.abs(got).max() > 0


def test_convert_refuses_unknown_named_tuple_state():
    from typing import NamedTuple

    class OtherState(NamedTuple):
        tail: np.ndarray

    with pytest.raises(NotImplementedError, match="OtherState"):
        convert.state_from_jax(OtherState(np.zeros(3)), "cpu")
    st = convert.state_from_jax(jfir.fir_init_state(5), "cpu")
    assert isinstance(st, fir.FirState) and st.tail.dtype == torch.complex64
