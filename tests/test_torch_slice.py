"""The fused flagship slice end to end on the CPU: the port's
``models.fm_channelizer(fused=True)`` run by ``fg.run(device="cpu")``
against the JAX package's same model (Pallas in interpret mode) on the
same numpy rows, against the float64 golden, and across a hand-over of
state from the reference to the port at a batch boundary.
"""

import numpy as np
import pytest
import torch

import jax

import bench
from newsched_tpu import models as jmodels
from newsched_tpu.blocks import general as jgen, vector_dsp as jvd
from newsched_tpu.ops import firdes
from newsched_tpu.parallel.channelizer import planes_rows as jplanes_rows
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import convert, models as tmodels, testing
from newsched_tpu_torch.blocks import analog as tanalog, general as tgen, \
    vector_dsp as tvd
from newsched_tpu_torch.ops import fir
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

GAIN = 0.5
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _design(M, L, A, decim):
    return (firdes.prototype_channelizer_taps(M, L),
            firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A))


def _noise_cf32(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
            ).astype(np.complex64)


def test_goldens_equal_the_reference_goldens():
    M = bench.NCHANS
    x = _noise_cf32(256 * M + 5, seed=1)
    rows = testing.planes_rows(x, M)
    np.testing.assert_array_equal(rows, jplanes_rows(x, M))
    skew = x[:M - 1]
    np.testing.assert_array_equal(testing.planes_rows(x, M, skew),
                                  jplanes_rows(x, M, skew))
    taps, at = bench._design()
    got, bad = testing.rows_reference(rows, taps, at, return_risk=True)
    ref, rbad = bench.rows_reference(rows, taps, at, return_risk=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(bad, rbad)
    assert testing.snr_db(ref, ref) == np.inf
    assert testing.snr_db(ref, got + 1e-3) == pytest.approx(bench.snr_db(ref, got + 1e-3))


def _models_run(pkg, M, L, A, decim, rows_per_batch, n_batches, source_data):
    """The same fused model in both packages over a replay source."""
    taps, at = _design(M, L, A, decim)
    gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
    if source_data.dtype == np.complex64:
        src = gen.vector_source(source_data)
    else:
        src = gen.vector_source(source_data, repeat=True)
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    fg, blks = models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, fused=True, source=src,
        batch_size=rows_per_batch * M, sink="vector",
        n_samples=n_batches * rows_per_batch // decim,
        deviation_frac=1.0 / (2 * np.pi * GAIN), audio_taps=at, **kw)
    if pkg == "jax":
        fg.run()
    else:
        fg.run(device="cpu")
    return blks["sink"].data(), taps, at


@pytest.mark.parametrize("M,L,A,decim,rows,nb", [(16, 8, 33, 4, 256, 3),
                                                 (64, 16, 65, 8, 1024, 2),
                                                 (128, 16, 65, 8, 512, 2)])
def test_fused_slice_replay_matches_reference_and_golden(M, L, A, decim, rows, nb):
    x = _noise_cf32(rows * M * 2, seed=M)
    planes = testing.planes_rows(x, M)  # repeated by the source
    got, taps, at = _models_run("torch", M, L, A, decim, rows, nb, planes)
    ref, _, _ = _models_run("jax", M, L, A, decim, rows, nb, planes)
    assert got.shape == ref.shape == (nb * rows // decim, M)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    stream = np.concatenate([planes] * -(-nb * rows // len(planes)))[:nb * rows]
    gold, bad = testing.rows_reference(stream, taps, at, nchans=M,
                                       audio_decim=decim, demod_gain=GAIN,
                                       return_risk=True)
    assert testing.snr_db(gold[~bad], got[~bad]) >= 95.0


def test_fused_slice_cf32_source_matches_reference():
    """A cf32 source goes through the cplx_to_planes adapter (skew carried
    across batches) in both packages."""
    M, L, A, decim, rows = 16, 8, 33, 4, 256
    x = _noise_cf32(rows * M * 3 - 7, seed=5)
    got, taps, at = _models_run("torch", M, L, A, decim, rows, 3, x)
    ref, _, _ = _models_run("jax", M, L, A, decim, rows, 3, x)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    planes = testing.planes_rows(x, M)
    gold = testing.rows_reference(planes[: len(planes) // decim * decim], taps,
                                  at, nchans=M, audio_decim=decim,
                                  demod_gain=GAIN)
    assert got.shape == gold.shape
    assert testing.snr_db(gold, got) >= 95.0


def test_fused_slice_default_noise_source_against_golden():
    """source=None: the port's position-pure noise stream, regenerated by
    the plain generator at the same absolute rows, through the golden."""
    M, L, A, decim, rows, nb = 16, 8, 33, 4, 256, 3
    taps, at = _design(M, L, A, decim)
    fg, blks = tmodels.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=decim, fused=True,
        batch_size=rows * M, sink="vector", n_samples=nb * rows // decim,
        deviation_frac=1.0 / (2 * np.pi * GAIN), audio_taps=at)
    assert isinstance(blks["source"], tvd.noise_planes_source)
    fg.run(device="cpu")
    stream = (noise.gaussian_rows_plain(0, n_rows=nb * rows, width=2 * M,
                                        seed=0, device="cpu")
              * torch.tensor(0.5)).numpy()
    gold, bad = testing.rows_reference(stream, taps, at, nchans=M,
                                       audio_decim=decim, demod_gain=GAIN,
                                       return_risk=True)
    got = blks["sink"].data()
    assert got.shape == gold.shape
    assert testing.snr_db(gold[~bad], got[~bad]) >= 95.0
    assert noise.gaussian_rows.launches == 0
    assert fm_chain.fm_chain_step_planes.launches == 0


def _default_taps_run(pkg, source, M, rows, nb):
    gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    if isinstance(source, np.ndarray):
        source = gen.vector_source(source, repeat=True)
    fg, blks = models.fm_channelizer(
        nchans=M, fused=True, source=source, batch_size=rows * M,
        sink="vector", n_samples=nb * rows // 8, **kw)
    if pkg == "jax":
        fg.run()
    else:
        fg.run(device="cpu")
    return blks["sink"].data(), blks["audio_taps"]


def test_fused_model_default_audio_taps_match_reference():
    """The model's own audio FIR (193 taps at 100 MS/s over 64 channels,
    decimation 8), longer than the port's chain tile of 128 rows: the
    fused replay model equals the reference's; the live model equals the
    fused model on its noise stream bit for bit."""
    M, rows, nb = 64, 512, 2
    planes = testing.planes_rows(_noise_cf32(rows * M * 2, seed=7), M)
    got, at = _default_taps_run("torch", planes, M, rows, nb)
    ref, jat = _default_taps_run("jax", planes, M, rows, nb)
    assert len(at) == len(jat) == 193
    assert got.shape == ref.shape == (nb * rows // 8, M)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    live, _ = _default_taps_run("torch", "live", M, rows, nb)
    fused, _ = _default_taps_run("torch", None, M, rows, nb)
    np.testing.assert_array_equal(live, fused)
    assert fm_chain.fm_chain_gen_step.launches == 0


def _handover_graph(pkg, x, M, L, A, decim):
    taps, at = _design(M, L, A, decim)
    gen, vd, Fg = ((jgen, jvd, JFlowgraph) if pkg == "jax"
                   else (tgen, tvd, TFlowgraph))
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    fg = Fg()
    src = gen.vector_source(x, name="src")
    adapter = vd.cplx_to_planes(M, name="adapter")
    fused = vd.fm_channelizer_fused_planes(M, taps, at, audio_decim=decim,
                                           gain=GAIN, name="fused", **kw)
    snk = gen.vector_sink(dtype="rf32", vlen=(M,), name="snk")
    fg.connect(src, 0, adapter, 0)
    fg.connect(adapter, 0, fused, 0)
    fg.connect(fused, 0, snk, 0)
    return fg


def test_states_from_jax_hand_over_at_batch_two():
    """JAX runs batch 1; its states (source position, adapter skew, fused
    carry/prev/atail) are converted; the port's batch 2 equals JAX's."""
    M, L, A, decim, rows = 16, 8, 33, 4, 256
    x = _noise_cf32(rows * M * 2, seed=11)
    jcfg = jcompile(_handover_graph("jax", x, M, L, A, decim), batch_size=rows * M)
    tcfg = tcompile(_handover_graph("torch", x, M, L, A, decim), batch_size=rows * M)
    jstep = jax.jit(jcfg.step)
    jparams = jcfg.init_params()
    s1, _ = jstep(jcfg.init_states(), jparams)
    s2, out2 = jstep(s1, jparams)
    states = convert.states_from_jax(jax.device_get(s1), "cpu")
    assert states["src"]["pos"] == rows * M
    assert states["adapter"]["skew"].dtype == torch.complex64
    _, tout = tcfg.step(states, convert.params_from_jax(jparams, "cpu"))
    got = tout["snk"].numpy()
    np.testing.assert_allclose(got, np.asarray(out2["snk"]), rtol=2e-4, atol=2e-5)
    assert np.abs(got).max() > 0


def test_convert_refuses_threefry_key_state():
    with pytest.raises(NotImplementedError, match="threefry"):
        convert.states_from_jax({"src": {"key": np.zeros(2, np.uint32)}}, "cpu")
    assert convert.state_from_jax((), "cpu") == ()
    # the reference's int32 pair becomes the one on-card int64 counter
    st = convert.states_from_jax({"s": {"ghi": np.int32(-1), "glo": np.int32(7)}},
                                 "cpu")
    assert list(st["s"]) == ["group"] and st["s"]["group"].dtype == torch.int64
    assert int(st["s"]["group"]) == noise.group64(-1, 7) == -(1 << 32) + 7


def test_slices_not_ported_yet_raise():
    with pytest.raises(NotImplementedError, match="threefry"):
        tvd.noise_planes_source(16, method="threefry")
    with pytest.raises(ValueError, match="multiples of 64"):
        tvd.noise_planes_source(16).init_state(0, 100, "cpu")
    M, L, A = 16, 8, 33
    consts = fm_chain.fm_chain_consts(np.ones((L, M), np.float32),
                                      np.ones(A, np.float32), "cpu")
    z = torch.zeros
    # warm > 0 runs (a time shard), and takes a halo of warm + H8 rows
    with pytest.raises(ValueError, match="warm"):
        fm_chain.fm_chain_step_planes(z(256, 2 * M), z(8, 2 * M), z(1, 2 * M),
                                      z(A - 1, 2 * M), consts, 4, 1.0, warm=256)
    # the "fft" method (config #3) is ported: the reference's result
    import jax.numpy as jnp
    from newsched_tpu.ops import fir as jfir

    xf = np.random.default_rng(1).standard_normal(64).astype(np.complex64)
    _, yf = fir.fir_filter(np.ones(9, np.float32), fir.fir_init_state(9, "cpu"),
                           torch.from_numpy(xf), method="fft")
    _, jyf = jfir.fir_filter(np.ones(9, np.float32),
                             jfir.fir_init_state(9), jnp.asarray(xf),
                             method="fft")
    np.testing.assert_allclose(yf.numpy(), np.asarray(jyf), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="uniform"):
        tanalog.noise_source("uniform")
    with pytest.raises(NotImplementedError, match="threefry"):
        tanalog.noise_source(method="threefry")
