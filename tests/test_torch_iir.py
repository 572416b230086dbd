"""The port's IIR (ops/iir.py, its chunked matrix form), the FM de- and
pre-emphasis, the AGC (ops/agc.py, its doubling scan) and the de-emphasised
wideband-FM receiver, held against scipy float64 at the reference's own
gates (twins of tests/test_ops_misc.py and tests/test_ops_property.py)
and against the JAX package on the same numpy inputs."""

import numpy as np
import pytest
import scipy.signal as sig
import torch
from hypothesis import assume, given, settings, strategies as st

import jax
import jax.numpy as jnp

from newsched_tpu import Flowgraph as JFlowgraph, models as jmodels
from newsched_tpu.blocks import analog as janalog, filter as jfilt, \
    general as jgen
from newsched_tpu.ops import agc as jagc, iir as jiir
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile

from newsched_tpu_torch import convert, models as tmodels, testing
from newsched_tpu_torch.blocks import analog as tanalog, filter as tfilt, \
    general as tgen
from newsched_tpu_torch.ops import agc, iir
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

snr_db = testing.snr_db
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _iir_stream(pkg, ff, fb, x, B):
    outs = []
    if pkg == "jax":
        s = jiir.iir_init_state(len(ff), len(fb), dtype=jnp.asarray(x).dtype)
        for i in range(0, len(x), B):
            s, y = jiir.iir_filter(jnp.asarray(ff), jnp.asarray(fb), s,
                                   jnp.asarray(x[i:i + B]))
            outs.append(np.asarray(y))
    else:
        s = iir.iir_init_state(len(ff), len(fb), "cpu",
                               torch.from_numpy(x).dtype)
        for i in range(0, len(x), B):
            s, y = iir.iir_filter(ff, fb, s, torch.from_numpy(x[i:i + B]))
            outs.append(y.numpy())
    return np.concatenate(outs)


# -- ops/iir.py ----------------------------------------------------------------

def test_iir_matches_scipy():
    """Twin of tests/test_ops_misc.py's: an order-4 Butterworth in 4
    streamed batches, > 80 dB against scipy; >= 100 dB against the
    reference's associative scan."""
    b, a = sig.butter(4, 0.2)
    ff, fb = iir.lfilter_taps(b, a)
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    y = _iir_stream("torch", ff, fb, x, 1024)
    assert snr_db(sig.lfilter(b, a, x.astype(np.float64)), y) > 80
    assert snr_db(_iir_stream("jax", ff, fb, x, 1024), y) >= 100


def test_iir_first_order():
    ff, fb = np.float32([0.1]), np.float32([0.9])
    x = np.ones(1000, dtype=np.float32)
    y = _iir_stream("torch", ff, fb, x, 1000)
    ref = sig.lfilter([0.1], [1, -0.9], x.astype(np.float64))
    assert snr_db(ref, y) > 80
    assert snr_db(_iir_stream("jax", ff, fb, x, 1000), y) >= 100


@pytest.mark.parametrize("pole", [0.765, 0.99, 0.999])
@pytest.mark.parametrize("B", [3, 1000, 104448])
def test_iir_chunk_form_near_the_unit_circle(pole, B):
    """The chunk form's precision where poles accumulate within a chunk:
    one pole at config #1's de-emphasis (0.765 at 50 kHz, 75 us), 0.99 and
    0.999, in batches of 3 (fewer than a chunk), 1000 and config #1's
    104448 audio samples: >= 80 dB against scipy float64."""
    b, a = [1.0 - pole], [1.0, -pole]
    ff, fb = iir.lfilter_taps(b, a)
    n = 2 * B if B > 1000 else 3000
    x = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    y = _iir_stream("torch", ff, fb, x, B)
    assert snr_db(sig.lfilter(b, a, x.astype(np.float64)), y) >= 80


def test_iir_chunk_constants_and_refusal():
    """K * order stays within 1024 (the chunk length a power of two from
    16 to 1024, at least the order), and constants built for one batch
    length refuse another."""
    for n, order in ((104448, 1), (4096, 4), (10, 20), (1 << 22, 1)):
        C = iir.chunk_length(n, order)
        assert C >= max(order, 16) and C & (C - 1) == 0 and C <= 1024
        assert -(-n // C) * order <= 1024 or C == 1024
    b, a = sig.butter(2, 0.3)
    ff, fb = iir.lfilter_taps(b, a)
    c = iir.iir_consts(ff, fb, 512, "cpu")
    with pytest.raises(ValueError, match="512"):
        iir.iir_filter(ff, fb, iir.iir_init_state(3, 2, "cpu"),
                       torch.zeros(256), consts=c)


def test_iir_complex_stream_matches_reference():
    """A complex stream through real taps (an order-3 Butterworth): > 80 dB
    against scipy and at least as close to it as the reference's scan.
    Against the reference itself >= 90 dB: its companion-matrix scan is
    further from float64 here than the chunk form, so their agreement is
    the reference's own error."""
    b, a = sig.butter(3, 0.1)
    ff, fb = iir.lfilter_taps(b, a)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)
         ).astype(np.complex64)
    y = _iir_stream("torch", ff, fb, x, 512)
    ref = sig.lfilter(b, a, x.astype(np.complex128))
    jy = _iir_stream("jax", ff, fb, x, 512)
    assert y.dtype == np.complex64
    assert snr_db(ref, y) > 80 and snr_db(ref, y) >= snr_db(ref, jy)
    assert snr_db(jy, y) >= 90


@settings(max_examples=12, deadline=None)
@given(
    npoles=st.integers(1, 4),
    nzeros=st.integers(0, 4),
    n_batches=st.integers(1, 3),
    seed=st.integers(0, 99),
)
def test_iir_random_stable_filter_matches_scipy(npoles, nzeros, n_batches,
                                                 seed):
    """Twin of tests/test_ops_property.py's: random stable filters (poles
    inside |z| < 0.95) streamed in batches of 512, > 60 dB against scipy."""
    rng = np.random.default_rng(seed)
    poles = []
    while len(poles) < npoles:
        if npoles - len(poles) >= 2 and rng.random() < 0.5:
            r = 0.95 * rng.random()
            th = np.pi * rng.random()
            poles += [r * np.exp(1j * th), r * np.exp(-1j * th)]
        else:
            poles.append(complex(0.95 * (2 * rng.random() - 1)))
    a = np.real(np.poly(poles[:npoles])).astype(np.float64)
    b = np.real(np.poly(1.8 * (rng.random(nzeros) - 0.5))) if nzeros else np.ones(1)
    b = (b * 0.5).astype(np.float64)
    B = 512
    x = rng.standard_normal(B * n_batches).astype(np.float32)
    ff, fb = iir.lfilter_taps(b, a)
    got = _iir_stream("torch", ff, fb, x, B)
    ref = sig.lfilter(b, a, x.astype(np.float64))
    assume(np.max(np.abs(ref)) < 1e3)
    assert snr_db(ref, got) > 60, (npoles, nzeros, seed)


# -- blocks ----------------------------------------------------------------------

def _graph_run(pkg, blk_fn, x, dtype, batch):
    Fg, gen = (JFlowgraph, jgen) if pkg == "jax" else (TFlowgraph, tgen)
    fg = Fg(batch_size=batch)
    blk = blk_fn()
    snk = gen.vector_sink(dtype=dtype)
    fg.connect(gen.vector_source(x, dtype=dtype), 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return np.asarray(snk.data())


@pytest.mark.parametrize("deemph", [True, False])
def test_fm_emphasis_blocks_vs_scipy(deemph):
    """Twin of tests/test_ops_misc.py's: fm_deemph / fm_preemph in a graph
    > 100 dB against scipy with the same bilinear-transform taps (equal to
    the reference's taps), and >= 100 dB against the reference's block."""
    fs = 48000.0
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    b, a = tanalog._emphasis_taps(fs, 75e-6, None, deemph)
    jb, ja = janalog._emphasis_taps(fs, 75e-6, None, deemph)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    ref = sig.lfilter(b, a, x.astype(np.float64))
    mods = {"jax": janalog, "torch": tanalog}
    out = {pkg: _graph_run(pkg, lambda m=m: (m.fm_deemph(fs) if deemph
                                             else m.fm_preemph(fs)),
                           x, "rf32", 1024)
           for pkg, m in mods.items()}
    assert snr_db(ref, out["torch"]) > 100
    assert snr_db(out["jax"], out["torch"]) >= 100


def test_iir_filter_and_moving_average_blocks_match_reference():
    x = np.random.default_rng(11).standard_normal(4096).astype(np.float32)
    b, a = sig.butter(4, 0.2)
    ff, fb = iir.lfilter_taps(b, a)
    for jf, tf in ((lambda: jfilt.iir_filter(ff, fb),
                    lambda: tfilt.iir_filter(ff, fb)),
                   (lambda: jfilt.moving_average(16, decim=2),
                    lambda: tfilt.moving_average(16, decim=2))):
        ref, got = _graph_run("jax", jf, x, "rf32", 1024), \
            _graph_run("torch", tf, x, "rf32", 1024)
        assert got.shape == ref.shape
        assert snr_db(ref, got) >= 100
    ma = _graph_run("torch", lambda: tfilt.moving_average(16, scale=2.0), x,
                    "rf32", 1024)
    np.testing.assert_allclose(ma, sig.lfilter(np.full(16, 2.0), [1.0], x),
                               rtol=1e-5, atol=1e-4)


def test_agc_converges_and_streams():
    """Twin of tests/test_ops_misc.py's: the converged tail near the
    reference level, and one batch equal to four streamed (> 100 dB)."""
    rng = np.random.default_rng(1)
    x = (0.1 * np.exp(1j * 2 * np.pi * rng.random(8192))).astype(np.complex64)
    s = agc.agc_init_state(1.0, "cpu")
    outs = []
    for i in range(4):
        s, y = agc.agc(s, torch.from_numpy(x[i * 2048:(i + 1) * 2048]),
                       rate=1e-2, reference=1.0)
        outs.append(y.numpy())
    y = np.concatenate(outs)
    assert abs(np.mean(np.abs(y[-1000:])) - 1.0) < 1e-2
    _, y_once = agc.agc(agc.agc_init_state(1.0, "cpu"), torch.from_numpy(x),
                        rate=1e-2, reference=1.0)
    assert snr_db(y_once.numpy(), y) > 100
    _, jy = jagc.agc(jagc.agc_init_state(1.0), jnp.asarray(x), rate=1e-2,
                     reference=1.0)
    assert snr_db(np.asarray(jy), y_once.numpy()) >= 100


def test_agc_reference_recurrence():
    """Twin of tests/test_ops_misc.py's: the scan against a literal loop,
    > 90 dB; with max_gain the clamp after the scan, as the reference."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)
         ).astype(np.complex64) * 0.3
    rate, ref = 0.05, 1.0
    g, ys = 1.0, []
    for xi in x:
        ys.append(xi * g)
        g = g + rate * (ref - abs(xi) * g)
    _, y = agc.agc(agc.agc_init_state(1.0, "cpu"), torch.from_numpy(x), rate=rate,
                   reference=ref)
    assert snr_db(np.array(ys), y.numpy()) > 90
    st, y = agc.agc(agc.agc_init_state(1.0, "cpu"), torch.from_numpy(x), rate=rate,
                    reference=ref, max_gain=1.2)
    jst, jy = jagc.agc(jagc.agc_init_state(1.0), jnp.asarray(x), rate=rate,
                       reference=ref, max_gain=1.2)
    assert snr_db(np.asarray(jy), y.numpy()) >= 100
    assert float(st.gain) == pytest.approx(float(jst.gain), rel=1e-6)


@pytest.mark.parametrize("dtype", ["cf32", "rf32"])
def test_agc_block_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(4096).astype(np.float32) * 0.2
    if dtype == "cf32":
        x = (x + 1j * rng.standard_normal(4096) * 0.2).astype(np.complex64)
    mods = {"jax": janalog, "torch": tanalog}
    out = {pkg: _graph_run(pkg, lambda m=m: m.agc(rate=1e-3, dtype=dtype), x,
                           dtype, 1024)
           for pkg, m in mods.items()}
    assert snr_db(out["jax"], out["torch"]) >= 100


# -- the de-emphasised receiver -----------------------------------------------

FS, FC, DEV, D, RD = 1e6, 200e3, 75e3, 4, 5
TAU = 75e-6


def _fm_signal(n):
    t = np.arange(n) / FS
    msg = np.sin(2 * np.pi * 2000.0 * t)
    ph = np.cumsum(2 * np.pi * (DEV / FS) * msg)
    return (np.exp(1j * ph) * np.exp(2j * np.pi * FC * t)).astype(np.complex64)


@pytest.mark.parametrize("fused", [False, True])
def test_wbfm_receiver_deemph_matches_reference(fused):
    """wbfm_receiver(deemph_tau=75e-6), staged and fused, on a cf32 FM
    signal against the JAX package's model (interpret mode, HIGHEST),
    two batches: >= 100 dB; the de-emphasis is the float64 lfilter of the
    receiver without it (>= 60 dB)."""
    n = 2 * 40960
    x = _fm_signal(n)

    def run(pkg, tau):
        gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
        kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
        fg, blks = models.wbfm_receiver(
            fs=FS, center_freq=FC, quad_rate_decim=D, audio_decim=(1, RD),
            deviation=DEV, source=gen.vector_source(x), batch_size=40960,
            fused=fused, deemph_tau=tau, **kw)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        return np.asarray(blks["sink"].data()), blks

    got, blks = run("torch", TAU)
    ref, _ = run("jax", TAU)
    assert isinstance(blks["deemph"], tanalog.fm_deemph)
    assert got.shape == ref.shape == (n // (D * RD),)
    assert snr_db(ref, got) >= 100
    plain, _ = run("torch", None)
    b, a = tanalog._emphasis_taps(FS / D / RD, TAU, None, True)
    assert snr_db(sig.lfilter(b, a, plain.astype(np.float64)), got) >= 60


def test_wbfm_live_deemph_is_the_live_audio_deemphasised():
    """The live form with deemph_tau: the live audio through the float64
    de-emphasis (>= 60 dB)."""
    def run(tau):
        fg, blks = tmodels.wbfm_receiver(
            fs=FS, center_freq=FC, quad_rate_decim=D, audio_decim=(1, RD),
            deviation=DEV, source="live", batch_size=40960, fused=True,
            n_samples=2 * 40960 // (D * RD), deemph_tau=tau)
        blks["source"].set_frequency(231_250.0)
        fg.run(device="cpu")
        return blks["sink"].data(), blks

    got, blks = run(TAU)
    plain, _ = run(None)
    assert blks["deemph"] is not None and got.shape == plain.shape
    b, a = tanalog._emphasis_taps(FS / D / RD, TAU, None, True)
    assert snr_db(sig.lfilter(b, a, plain.astype(np.float64)), got) >= 60


def test_fm_deemph_states_from_jax_hand_over_at_batch_two():
    """The reference runs batch one of vector_source -> fm_deemph; the
    converted IirState (its FirState inside) carries the port's batch two
    to the reference's (>= 100 dB)."""
    n, fs = 2048, 50000.0
    x = np.random.default_rng(12).standard_normal(2 * n).astype(np.float32)

    def graph(pkg):
        Fg, gen, an = ((JFlowgraph, jgen, janalog) if pkg == "jax"
                       else (TFlowgraph, tgen, tanalog))
        fg = Fg()
        blk = an.fm_deemph(fs, name="de")
        fg.connect(gen.vector_source(x, dtype="rf32", name="src"), 0, blk, 0)
        fg.connect(blk, 0, gen.vector_sink(dtype="rf32", name="snk"), 0)
        return fg

    jcfg = jcompile(graph("jax"), batch_size=n)
    tcfg = tcompile(graph("torch"), batch_size=n)
    jparams = jcfg.init_params()
    s1, _ = jcfg.step(jcfg.init_states(), jparams)
    _, out2 = jcfg.step(s1, jparams)
    states = convert.states_from_jax(jax.device_get(s1), "cpu")
    assert isinstance(states["de"], iir.IirState)
    assert float(states["de"].y_hist[0]) != 0.0
    _, tout = tcfg.step(states, convert.params_from_jax(
        jax.device_get(jparams), "cpu"))
    assert snr_db(np.asarray(out2["snk"]), tout["snk"].numpy()) >= 100
    ag = convert.state_from_jax(jagc.agc_init_state(0.5), "cpu")
    assert isinstance(ag, agc.AgcState) and float(ag.gain) == 0.5
