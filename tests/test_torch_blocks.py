"""The port's math, streamops and fft blocks in flowgraphs, held against
the JAX package's (twins of tests/test_runtime_graph.py's uses): each
graph is built the same way in both packages on the same numpy inputs,
and the sinks' data must be equal (within 1e-6 where float rounding of
an FFT or a magnitude enters)."""

import numpy as np
import pytest
import torch

from newsched_tpu import Flowgraph as JFlowgraph
from newsched_tpu.blocks import fft as jfft, general as jgen, math as jmath, \
    streamops as jstream

from newsched_tpu_torch.blocks import fft as tfft, general as tgen, \
    math as tmath, streamops as tstream
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

PKGS = {"jax": (JFlowgraph, jgen, jmath, jstream, jfft),
        "torch": (TFlowgraph, tgen, tmath, tstream, tfft)}


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


def _both(build):
    """build(Fg, gen, math, stream, fft) -> (fg, [sinks]) in each package;
    returns each package's list of sink data."""
    out = {}
    for pkg, mods in PKGS.items():
        fg, sinks = build(*mods)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        out[pkg] = [np.asarray(s.data()) for s in sinks]
    return out["jax"], out["torch"]


def _chain(data, mid, batch, dtype="cf32", out_dtype=None, vlen=(),
           out_vlen=None):
    """vector_source(data) -> mid -> vector_sink."""
    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=batch)
        blk = mid(m, s, f)
        snk = gen.vector_sink(dtype=out_dtype or dtype,
                              vlen=vlen if out_vlen is None else out_vlen)
        fg.connect(gen.vector_source(data, dtype=dtype, vlen=vlen), 0, blk, 0)
        fg.connect(blk, 0, snk, 0)
        return fg, [snk]
    return build


# -- twins of tests/test_runtime_graph.py -----------------------------------

def test_rate_mismatch_rejected():
    for Fg, gen, m, s, _ in PKGS.values():
        fg = Fg(batch_size=64)
        src = gen.null_source()
        d = s.keep_one_in_n(2)
        adder = m.add(2)
        fg.connect(src, 0, d, 0)
        fg.connect(src, 0, adder, 0)
        fg.connect(d, 0, adder, 1)
        fg.connect(adder, 0, gen.null_sink(), 0)
        with pytest.raises(ValueError, match="rate mismatch"):
            fg.run() if Fg is JFlowgraph else fg.run(device="cpu")


@pytest.mark.parametrize("n_skip", [100, 128, 300, 999])
def test_skiphead(n_skip):
    """Skip counts below, equal to and well beyond one batch, through the
    compiler's finite_items and lead_items hooks."""
    data = np.arange(1000, dtype=np.float32)
    (j,), (t,) = _both(_chain(data, lambda m, s, f: s.skiphead(n_skip,
                                                               dtype="rf32"),
                              128, "rf32"))
    np.testing.assert_array_equal(t, data[n_skip:])
    np.testing.assert_array_equal(t, j)


def test_delay():
    data = np.arange(256, dtype=np.float32)
    (j,), (t,) = _both(_chain(data, lambda m, s, f: s.delay(10, dtype="rf32"),
                              64, "rf32"))
    np.testing.assert_array_equal(
        t, np.concatenate([np.zeros(10, np.float32), data])[:256])
    np.testing.assert_array_equal(t, j)


def test_streams_to_vector_roundtrip():
    n = 3
    data = [np.arange(120, dtype=np.float32) * (k + 1) for k in range(n)]

    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=40)
        s2v = s.streams_to_vector(n, dtype="rf32")
        v2s = s.vector_to_streams(n, dtype="rf32")
        snks = [gen.vector_sink(dtype="rf32") for _ in range(n)]
        for k in range(n):
            fg.connect(gen.vector_source(data[k], dtype="rf32"), 0, s2v, k)
            fg.connect(v2s, k, snks[k], 0)
        fg.connect(s2v, 0, v2s, 0)
        return fg, snks

    j, t = _both(build)
    for k in range(n):
        np.testing.assert_array_equal(t[k], data[k])
        np.testing.assert_array_equal(t[k], j[k])


# -- math ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["add", "multiply"])
def test_nary_math_blocks(name):
    xs = [_rand_complex(512, seed=k) for k in range(3)]

    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=128)
        blk = getattr(m, name)(3)
        for k in range(3):
            fg.connect(gen.vector_source(xs[k]), 0, blk, k)
        snk = gen.vector_sink()
        fg.connect(blk, 0, snk, 0)
        return fg, [snk]

    (j,), (t,) = _both(build)
    # a complex product rounds as XLA fuses it (FMAs): within 1e-6
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,dtype,k", [
    ("add_const", "cf32", 1.5 - 2j), ("multiply_const", "cf32", 0.5 + 1j),
    ("add_const", "rf32", -3.25), ("multiply_const", "rf32", 2.5)])
def test_const_math_blocks(name, dtype, k):
    x = _rand_complex(512, seed=5)
    if dtype == "rf32":
        x = x.real.copy()
    (j,), (t,) = _both(_chain(x, lambda m, s, f: getattr(m, name)(k, dtype),
                              128, dtype))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,out", [
    ("conjugate", "cf32"), ("complex_to_mag", "rf32"),
    ("complex_to_mag_squared", "rf32"), ("complex_to_real", "rf32"),
    ("complex_to_imag", "rf32")])
def test_complex_math_blocks(name, out):
    x = _rand_complex(512, seed=6)
    (j,), (t,) = _both(_chain(x, lambda m, s, f: getattr(m, name)(), 128,
                              "cf32", out))
    assert t.dtype == np.dtype(np.complex64 if out == "cf32" else np.float32)
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_float_to_complex_and_abs():
    re = np.random.default_rng(1).standard_normal(256).astype(np.float32)
    im = np.random.default_rng(2).standard_normal(256).astype(np.float32)

    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=64)
        f2c, ab = m.float_to_complex(), m.abs_blk()
        snk, snk2 = gen.vector_sink(), gen.vector_sink(dtype="rf32")
        fg.connect(gen.vector_source(re, dtype="rf32"), 0, f2c, 0)
        fg.connect(gen.vector_source(im, dtype="rf32"), 0, f2c, 1)
        fg.connect(f2c, 0, snk, 0)
        fg.connect(gen.vector_source(im, dtype="rf32"), 0, ab, 0)
        fg.connect(ab, 0, snk2, 0)
        return fg, [snk, snk2]

    j, t = _both(build)
    np.testing.assert_array_equal(t[0], (re + 1j * im).astype(np.complex64))
    np.testing.assert_array_equal(t[1], np.abs(im))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


# -- streamops -----------------------------------------------------------------

@pytest.mark.parametrize("make,batch", [
    (lambda s: s.keep_one_in_n(4), 256),
    (lambda s: s.keep_m_in_n(2, 6, offset=3), 240),
    (lambda s: s.repeat(3), 128),
    (lambda s: s.delay(0), 128),
    (lambda s: s.skiphead(0), 128)])
def test_rate_blocks(make, batch):
    x = _rand_complex(960, seed=7)
    (j,), (t,) = _both(_chain(x, lambda m, s, f: make(s), batch))
    assert len(t) > 0
    np.testing.assert_array_equal(t, j)


def test_interleave_deinterleave_roundtrip():
    a, b = _rand_complex(384, seed=1), _rand_complex(384, seed=2)

    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=96)
        il = s.interleave(2, blocksize=4)
        de = s.deinterleave(2, blocksize=4)
        mid, snks = gen.vector_sink(), [gen.vector_sink(), gen.vector_sink()]
        fg.connect(gen.vector_source(a), 0, il, 0)
        fg.connect(gen.vector_source(b), 0, il, 1)
        fg.connect(il, 0, mid, 0)
        fg.connect(il, 0, de, 0)
        fg.connect(de, 0, snks[0], 0)
        fg.connect(de, 1, snks[1], 0)
        return fg, [mid, *snks]

    j, t = _both(build)
    np.testing.assert_array_equal(
        t[0], np.stack([a.reshape(-1, 4), b.reshape(-1, 4)], 1).reshape(-1))
    np.testing.assert_array_equal(t[1], a)
    np.testing.assert_array_equal(t[2], b)
    for x, y in zip(j, t):
        np.testing.assert_array_equal(x, y)


def test_stream_to_vector_and_back():
    x = _rand_complex(512, seed=3)

    def build(Fg, gen, m, s, f):
        fg = Fg(batch_size=128)
        s2v, v2s = s.stream_to_vector(16), s.vector_to_stream(16)
        vs, snk = gen.vector_sink(vlen=(16,)), gen.vector_sink()
        fg.connect(gen.vector_source(x), 0, s2v, 0)
        fg.connect(s2v, 0, vs, 0)
        fg.connect(s2v, 0, v2s, 0)
        fg.connect(v2s, 0, snk, 0)
        return fg, [vs, snk]

    j, t = _both(build)
    np.testing.assert_array_equal(t[0], x.reshape(-1, 16))
    np.testing.assert_array_equal(t[1], x)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


# -- fft -----------------------------------------------------------------------

@pytest.mark.parametrize("forward,shift", [(True, False), (True, True),
                                           (False, False)])
def test_fft_block_matches_reference(forward, shift):
    """Vector items of 64 through the fft block with a window: within 1e-6
    of max|out| of the reference's."""
    x = _rand_complex(64 * 24, seed=9).reshape(24, 64)
    win = np.blackman(64)
    (j,), (t,) = _both(_chain(
        x, lambda m, s, f: f.fft(64, forward, window=win, shift=shift), 8,
        vlen=(64,)))
    assert t.shape == (24, 64) and t.dtype == np.complex64
    assert np.max(np.abs(t - j)) <= 1e-6 * np.max(np.abs(j))
    ref = np.fft.fft(x * win) if forward else np.fft.ifft(x * win)
    ref = np.fft.fftshift(ref, axes=-1) if shift else ref
    assert np.max(np.abs(t - ref)) <= 1e-5 * np.max(np.abs(ref))
