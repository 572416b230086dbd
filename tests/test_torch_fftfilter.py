"""Config #3 in the port: ops/fftops.py, the "fft" method of ops/fir.py on
its two engines (the native transform pair "xla", torch.fft; the Bailey
fast convolution "mxu"), the fft_filter block, the sharded FIR and the
config #3 flowgraph, held against the JAX package on the same numpy
inputs and against scipy float64."""

import logging

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax
import jax.numpy as jnp

from newsched_tpu import Flowgraph as JFlowgraph
from newsched_tpu.blocks import filter as jfilt, general as jgen
from newsched_tpu.ops import fftops as jfftops, fir as jfir
from newsched_tpu.parallel import make_mesh as jmake_mesh
from newsched_tpu.parallel.sharded_fir import ShardedFirFilter as JShardedFir
from newsched_tpu.runtime import tags as jtags
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile

from newsched_tpu_torch import bench, convert
from newsched_tpu_torch.blocks import filter as tfilt, general as tgen
from newsched_tpu_torch.ops import fftops, fir, firdes
from newsched_tpu_torch.parallel import ShardedFirFilter, make_mesh
from newsched_tpu_torch.runtime import runner as trunner, tags as ttags
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph
from newsched_tpu_torch.testing import snr_db


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _stream(pkg, taps, x, splits, decim=1, **kw):
    """fir_filter over consecutive batches of x in either package."""
    out, i0 = [], 0
    if pkg == "jax":
        s = jfir.fir_init_state(len(taps), dtype=jnp.asarray(x).dtype)
        for b in splits:
            s, y = jfir.fir_filter(taps, s, jnp.asarray(x[i0:i0 + b]),
                                   decim=decim, **kw)
            out.append(np.asarray(y))
            i0 += b
    else:
        s = fir.fir_init_state(len(taps), "cpu", torch.from_numpy(x).dtype)
        for b in splits:
            s, y = fir.fir_filter(taps, s, torch.from_numpy(x[i0:i0 + b]),
                                  decim=decim, **kw)
            out.append(y.numpy())
            i0 += b
    return np.concatenate(out)


# -- ops/fftops.py fft -------------------------------------------------------

@pytest.mark.parametrize("forward", [True, False])
def test_fft_window_shift_and_inverse_match_reference(forward):
    x = _rand_complex(4 * 256, seed=1).reshape(4, 256)
    win = np.hanning(256).astype(np.float32)
    for window, shift in ((None, False), (win, False), (win, True)):
        ref = np.asarray(jfftops.fft(jnp.asarray(x), forward, window, shift))
        got = fftops.fft(torch.from_numpy(x), forward, window, shift)
        assert got.dtype == torch.complex64
        assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))


# -- the two engines ---------------------------------------------------------

TAPS_1024 = np.asarray(firdes.low_pass(1.0, 1.0, 0.1, 0.03, ntaps=1024),
                       np.float32)


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("decim", [1, 4])
def test_engines_match_reference_engine_and_scipy(engine, decim):
    """Three batches of 20480 at 1024 taps: >= 100 dB against the
    reference's same engine, >= 90 dB against scipy float64."""
    x = _rand_complex(3 * 20480, seed=3)
    kw = dict(method="fft", fft_method=engine)
    got = _stream("torch", TAPS_1024, x, [20480] * 3, decim, **kw)
    ref = _stream("jax", TAPS_1024, x, [20480] * 3, decim, **kw)
    gold = sig.lfilter(TAPS_1024.astype(np.float64), [1.0],
                       x.astype(np.complex128))[::decim]
    assert got.dtype == np.complex64 and got.shape == ref.shape
    assert snr_db(ref, got) >= 100
    assert snr_db(gold, got) >= 90


def test_fft_filter_bailey_mxu_matches_scipy():
    """Twin of tests/test_ops_fir.py's: the Bailey engine streaming three
    batches, > 90 dB against scipy."""
    rng = np.random.default_rng(3)
    taps = np.asarray(firdes.low_pass(1.0, 1.0, 0.1, 0.03, ntaps=1024),
                      np.float32)
    n = 3 * 20480
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    y = _stream("torch", taps, x, [n // 3] * 3, method="fft", fft_method="mxu")
    ref = sig.lfilter(taps.astype(np.float64), [1.0], x.astype(np.complex128))
    assert snr_db(ref, y) > 90


def test_fft_filter_bailey_decim_and_errors():
    """Twin of tests/test_ops_fir.py's: decimation by 4 at 513 taps, and
    the reference's refusals (a real stream, an fft_size other than 16384,
    tensor taps)."""
    rng = np.random.default_rng(4)
    taps = np.asarray(firdes.low_pass(1.0, 1.0, 0.05, 0.02, ntaps=513),
                      np.float32)
    n = 40960
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    y = _stream("torch", taps, x, [n], 4, method="fft", fft_method="mxu")
    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::4]
    assert snr_db(ref, y) > 90
    sr = fir.fir_init_state(513, "cpu", torch.float32)
    xr = torch.from_numpy(np.real(x).copy())
    with pytest.raises(ValueError, match="complex"):
        fir.fir_filter(taps, sr, xr, method="fft", fft_method="mxu")
    s = fir.fir_init_state(513, "cpu")
    with pytest.raises(ValueError, match="fft_size"):
        fir.fir_filter(taps, s, torch.from_numpy(x), method="fft",
                       fft_method="mxu", fft_size=4096)
    with pytest.raises(ValueError, match="static"):
        fir.fir_filter(torch.from_numpy(taps), s, torch.from_numpy(x),
                       method="fft", fft_method="mxu")
    with pytest.raises(ValueError, match="overlap"):
        fftops.bailey_plan(np.ones(128 * 128, np.float32))
    with pytest.raises(ValueError, match="auto/xla/mxu"):
        tfilt.fft_filter(taps, fft_method="cufft")


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fft_filter_streaming_property(engine, seed):
    """Twin of tests/test_ops_fir.py's Bailey property, on both engines:
    random taps, decimation and uneven batch splits equal scipy on the
    whole stream, >= 85 dB."""
    rng = np.random.default_rng(seed + 10)
    ntaps = int(rng.integers(400, 2000))
    decim = int(rng.choice([1, 2, 4]))
    taps = (rng.standard_normal(ntaps) * np.hanning(ntaps)).astype(np.float32)
    splits = [16384, 20480, 18432]
    n = sum(splits)
    pad = (-n) % decim
    splits[-1] += pad
    n += pad
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    y = _stream("torch", taps, x, splits, decim, method="fft",
                fft_method=engine)
    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::decim]
    assert snr_db(ref[: len(y)], y) > 85


def test_real_stream_rfft_path_and_leading_axes():
    """A real stream takes rfft/irfft (float32 out) on the "xla" engine and
    equals the reference's; a (2, n) stream filters each row as the 1-D
    stream."""
    x = np.random.default_rng(6).standard_normal(3 * 8192).astype(np.float32)
    taps = TAPS_1024[:700].copy()
    got = _stream("torch", taps, x, [8192] * 3, method="fft")
    ref = _stream("jax", taps, x, [8192] * 3, method="fft")
    gold = sig.lfilter(taps.astype(np.float64), [1.0], x.astype(np.float64))
    assert got.dtype == np.float32
    assert snr_db(ref, got) >= 100 and snr_db(gold, got) >= 90
    xx = np.stack([x, x[::-1].copy()])
    s = fir.fir_init_state(700, "cpu", torch.float32, batch_shape=(2,))
    _, yy = fir.fir_filter(taps, s, torch.from_numpy(xx), method="fft")
    for r in range(2):
        _, y1 = fir.fir_filter(taps, fir.fir_init_state(700, "cpu",
                                                        torch.float32),
                               torch.from_numpy(xx[r]), method="fft")
        np.testing.assert_allclose(yy[r].numpy(), y1.numpy(), rtol=0,
                                   atol=1e-6)


def test_auto_choices():
    """"auto" takes "fft" above 384 taps (equal to method="fft"), its
    engine is "xla" on the CPU as the reference's, and the segment size
    follows the reference's adaptive rule."""
    x = _rand_complex(8192, seed=2)
    taps = TAPS_1024[:385].copy()
    np.testing.assert_array_equal(
        _stream("torch", taps, x, [8192]),
        _stream("torch", taps, x, [8192], method="fft", fft_method="xla"))
    for n_lin in (8192, 1 << 21, 20000):
        ft = fir.fft_taps(TAPS_1024, n_lin, True, "cpu")
        assert ft.engine == "xla" and ft.auto
        ref = max(jfir._good_fft_size(4 * 1024),
                  min(jfir._good_fft_size(max(n_lin // 128, 1)), 16384), 4096)
        assert ft.fft_size == min(ref, jfir._good_fft_size(n_lin + 1023))
    for n in (1, 7, 384, 1000, 16385, 99999):
        assert fir._good_fft_size(n) == jfir._good_fft_size(n)
    assert fir.fft_engine("mxu", True, True, None) == "mxu"
    with pytest.raises(ValueError, match="auto/xla/mxu"):
        fir.fft_engine("cufft", True, True, None)
    assert fftops.bailey_supported(1024, None) and \
        not fftops.bailey_supported(1024, 8192)


def test_auto_engine_is_logged_once_per_block(caplog):
    """When "auto" picks the engine (and with it the accuracy tier), the
    block logs which, once."""
    caplog.set_level(logging.INFO, logger="newsched_tpu_torch")
    x = _rand_complex(3 * 4096, seed=8)
    fg = TFlowgraph(batch_size=4096)
    blk = tfilt.fft_filter(TAPS_1024, name="ff_auto")
    snk = tgen.vector_sink()
    fg.connect(tgen.vector_source(x), 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run(device="cpu")
    msgs = [r.getMessage() for r in caplog.records
            if r.name.endswith("ff_auto")]
    assert len(msgs) == 1 and "'xla'" in msgs[0] and "FP32" in msgs[0]
    caplog.clear()
    fg = TFlowgraph(batch_size=4096)
    blk = tfilt.fft_filter(TAPS_1024, fft_method="xla", name="ff_xla")
    fg.connect(tgen.vector_source(x), 0, blk, 0)
    fg.connect(blk, 0, tgen.vector_sink(), 0)
    fg.run(device="cpu")
    assert not [r for r in caplog.records if r.name.endswith("ff_xla")]


# -- the block in graphs -------------------------------------------------------

def test_tags_through_fft_filter_with_data_check():
    """Twin of tests/test_tags.py's: the fft_filter block with tags, both
    packages; the same tags, data > 90 dB against scipy and >= 100 dB
    against the reference."""
    data = _rand_complex(8192, seed=33)
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.02)
    tag_list = [(10, "sync", 7.0), (5000, "pkt", 1.0, 2.0)]
    out = {}
    for pkg, Fg, gen, filt in (("jax", JFlowgraph, jgen, jfilt),
                               ("torch", TFlowgraph, tgen, tfilt)):
        fg = Fg(batch_size=2048)
        src = gen.vector_source(data, tags=tag_list)
        ff = filt.fft_filter(taps)
        snk = gen.vector_sink()
        fg.connect(src, 0, ff, 0)
        fg.connect(ff, 0, snk, 0)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        out[pkg] = (snk.data(), [tuple(t) for t in snk.tags()])
    ref = sig.lfilter(taps.astype(np.float64), [1.0], data.astype(np.complex128))
    assert snr_db(ref, out["torch"][0]) > 90
    assert snr_db(out["jax"][0], out["torch"][0]) >= 100
    assert out["torch"][1] == out["jax"][1]
    assert [(t[0], t[1], t[2]) for t in out["torch"][1]] == \
        [(10, "sync", (7.0, 0.0)), (5000, "pkt", (1.0, 2.0))]


def test_tags_preserved_under_mesh():
    """Twin of tests/test_mesh_graph.py's config #3 gate: the fft_filter
    graph at decim 2 with tags on 8 logical shards equals the unsharded
    run (>= 120 dB), tags exact through the rate change."""
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.1, ntaps=33)
    x = _rand_complex(4096, seed=13)
    tag_list = [(0, "start", 1.0), (1000, "burst", 2.5), (3500, "end", 0.0)]

    def run(mesh):
        fg = TFlowgraph(batch_size=1024)
        src = tgen.vector_source(x, tags=tag_list)
        f = tfilt.fft_filter(taps, decim=2)
        snk = tgen.vector_sink()
        fg.connect(src, 0, f, 0)
        fg.connect(f, 0, snk, 0)
        fg.run(device="cpu", mesh=mesh)
        return snk.data(), snk.tags()

    ref_d, ref_t = run(None)
    got_d, got_t = run(make_mesh(8, device="cpu"))
    assert snr_db(ref_d, got_d) > 120
    assert [(t.offset, t.key) for t in got_t] == [(t.offset, t.key) for t in ref_t]
    assert [(t.offset, t.key) for t in got_t] == [(0, "start"), (500, "burst"),
                                                  (1750, "end")]


def _tag_batch(mod, offsets, as_array):
    k = len(offsets)
    return mod.TagBatch(offsets=as_array(np.asarray(offsets, np.int32)),
                        keys=as_array(np.zeros(k, np.int32)),
                        values=as_array(np.zeros((k, mod.VALUE_DIM),
                                                 np.float32)),
                        valid=as_array(np.ones(k, bool)))


def test_sharded_fft_filter_tags_preserved():
    """Twin of tests/test_parallel.py's config #3 test: ShardedFirFilter on
    8 logical shards, two batches with tags: > 90 dB against scipy, >= 100
    dB against the reference's on its 8 simulated devices, tag offsets
    remapped by 1/decim exactly; min_batch and the errors as the
    reference's."""
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.02, ntaps=129)
    decim = 2
    f = ShardedFirFilter(make_mesh(8, device="cpu"), taps, decim=decim)
    jf = JShardedFir(jmake_mesh(8), taps, decim=decim, method="fft")
    assert f.min_batch() == jf.min_batch()
    B = max(f.min_batch(), 8 * 512)
    x = _rand_complex(2 * B, seed=40)
    offs = [[7, B - 3], [11]]
    st, jst = f.init_state(), jf.init_state()
    outs, jouts, tag_offs = [], [], []
    for b in range(2):
        xb = x[b * B:(b + 1) * B]
        y, otags, st = f.step(torch.from_numpy(xb),
                              _tag_batch(ttags, offs[b], torch.from_numpy), st)
        outs.append(y.numpy())
        tag_offs.append(otags.offsets.tolist())
        jy, _, jst = jax.jit(jf.step)(
            jax.device_put(jnp.asarray(xb), jf.input_sharding()),
            _tag_batch(jtags, offs[b], jnp.asarray), jst)
        jouts.append(np.asarray(jy))
    y, jy = np.concatenate(outs), np.concatenate(jouts)
    ref = sig.lfilter(taps.astype(np.float64), [1.0],
                      x.astype(np.complex128))[::decim]
    assert snr_db(ref, y) > 90 and snr_db(jy, y) >= 100
    assert tag_offs == [[7 // decim, (B - 3) // decim], [11 // decim]]
    # the carry keeps the reference's layout, a block per shard, and
    # convert.py carries the reference's state over as it is
    np.testing.assert_array_equal(st.carry.numpy(), np.asarray(jst.carry))
    cst = convert.state_from_jax(jax.device_get(jst), "cpu")
    assert isinstance(cst, type(st))
    np.testing.assert_array_equal(cst.carry.numpy(), st.carry.numpy())
    with pytest.raises(ValueError, match="n_dev"):
        f.step(torch.zeros(8 * 512 + 1, dtype=torch.complex64), None, st)
    with pytest.raises(ValueError, match="halo"):
        f.step(torch.zeros(16, dtype=torch.complex64), None, st)


# -- config #3 -----------------------------------------------------------------

def test_config3_graph_against_float64_golden_and_loop():
    """Config #3's flowgraph (bench.fft_filter_graph: noise_source -> the
    1024-tap fft_filter -> head -> sink) at a small batch: >= 85 dB against
    the float64 golden of the port's own noise stream over three batches,
    the last cut by the head; the runner's graph-mode bookkeeping equals
    its loop bit for bit."""
    B = 16384
    n = 2 * B + 4096
    fg, b = bench.fft_filter_graph(n, B, "vector")
    fg.run(device="cpu")
    got = b["sink"].data()
    assert got.shape == (n,) and got.dtype == np.complex64
    assert snr_db(bench.fft_filter_golden(n, b["taps"]), got) >= 85
    fg2, b2 = bench.fft_filter_graph(n, B, "vector")
    trunner.Runner(fg2, device="cpu", batch_size=B)._run_graph(3, 2)
    np.testing.assert_array_equal(b2["sink"].data(), got)


def test_fft_filter_states_from_jax_hand_over_at_batch_two():
    """The reference runs batch one of vector_source -> fft_filter; the
    converted FirState carries the port's batch two to the reference's
    (>= 100 dB)."""
    n = 8192
    x = _rand_complex(2 * n, seed=21)

    def graph(pkg):
        Fg, gen, filt = ((JFlowgraph, jgen, jfilt) if pkg == "jax"
                         else (TFlowgraph, tgen, tfilt))
        fg = Fg()
        src = gen.vector_source(x, name="src")
        ff = filt.fft_filter(TAPS_1024, name="ff")
        fg.connect(src, 0, ff, 0)
        fg.connect(ff, 0, gen.vector_sink(name="snk"), 0)
        return fg

    jcfg = jcompile(graph("jax"), batch_size=n)
    tcfg = tcompile(graph("torch"), batch_size=n)
    jparams = jcfg.init_params()
    s1, _ = jcfg.step(jcfg.init_states(), jparams)
    _, out2 = jcfg.step(s1, jparams)
    states = convert.states_from_jax(jax.device_get(s1), "cpu")
    assert isinstance(states["ff"], fir.FirState)
    _, tout = tcfg.step(states, convert.params_from_jax(
        jax.device_get(jparams), "cpu"))
    assert snr_db(np.asarray(out2["snk"]), tout["snk"].numpy()) >= 100
