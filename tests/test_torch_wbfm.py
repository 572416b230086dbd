"""The wideband-FM receiver slice (BASELINE config #1) on the CPU: the NCO
sources (kernels K8 ``nco_planes`` and K11 ``nco_folded``, plain versions)
and their quarter-wave sin/cos, ``sig_source``, the staged chain's ops and
blocks (rotator, quadrature demod, ``freq_xlating_fir``,
``rational_resampler``), the fused and live chains (K10
``wbfm_chain_step`` and K12 ``wbfm_chain_live_step``, plain versions) and
``models.wbfm_receiver`` in its staged, fused and live forms, held against
the JAX package on the same numpy inputs (Pallas in interpret mode, at
HIGHEST precision so that like is compared with like) and against the
float64 golden. CUDA is never built here: every launch count stays 0.
"""

import inspect

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax
import jax.numpy as jnp

from newsched_tpu import models as jmodels
from newsched_tpu.blocks import analog as janalog, filter as jfilt, \
    general as jgen
from newsched_tpu.ops import analog as jaops, fir as jfir, nco as jnco
from newsched_tpu.ops.pallas import mathfns as jmath, sources as jsrc, \
    wbfm_chain as jwc
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import convert, models as tmodels, testing
from newsched_tpu_torch.blocks import analog as tanalog, filter as tfilt, \
    general as tgen
from newsched_tpu_torch.ops import analog as taops, fir, firdes, nco
from newsched_tpu_torch.ops import iir as tiir
from newsched_tpu_torch.ops.cuda import mathfns, sources, wbfm_chain
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph
from newsched_tpu_torch.runtime.runner import Runner

HIGHEST = jax.lax.Precision.HIGHEST
FS, FC, DEV, D, RD = 1e6, 200e3, 75e3, 4, 5
TONE = 231_250.0  # 31.25 kHz into the 100 kHz channel: nonzero audio
NCO_TOL = 1.5e-7  # plain vs the Pallas NCO at amp <= 0.8: 2 ulp (XLA fuses
#                   the polynomial's multiply-adds into FMAs)
CHAIN_TOL = 2e-6  # plain vs the Pallas chain at HIGHEST, audio ~1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_cfg():
    """tests/test_wbfm_fused.py's small chain: 25 channel taps, 15
    resampler taps, D = 4, Rd = 5."""
    c = sig.firwin(25, 0.2)
    rt = sig.firwin(15, 0.15)
    dphase = int(round(0.21 * 2**32)) & 0xFFFFFFFF
    return c, rt, dphase, 4, 5, 0.7


def _plans(c, rt, dphase, D, Rd, gain):
    return (jwc.WbfmChainPlan(c, dphase, D, rt, Rd, gain, precision=HIGHEST),
            wbfm_chain.WbfmChainPlan(c, dphase, D, rt, Rd, gain))


def _cf32(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _launches():
    return (sources.nco_planes.launches, sources.nco_folded.launches,
            wbfm_chain.wbfm_chain_step.launches,
            wbfm_chain.wbfm_chain_live_step.launches)


# -- the NCO and its sin/cos -------------------------------------------------

def test_sincos_coeffs_equal_reference_bit_for_bit():
    assert mathfns.SINCOS_COEFFS.dtype == np.float32
    np.testing.assert_array_equal(mathfns.SINCOS_COEFFS[0], jmath._SIN_C)
    np.testing.assert_array_equal(mathfns.SINCOS_COEFFS[1], jmath._COS_C)


def test_sin_cos_turns_plain_matches_reference_and_float64():
    rng = np.random.default_rng(3)
    t = np.concatenate([rng.uniform(-3, 3, 1 << 14),
                        np.arange(-8, 9) / 4.0]).astype(np.float32)
    sn, cs = mathfns.sin_cos_turns_plain(torch.from_numpy(t))
    js, jc = jmath.sin_cos_turns(jnp.asarray(t))
    # 2.4e-7: two ulp of the polynomial (XLA contracts it into FMAs)
    np.testing.assert_allclose(sn.numpy(), np.asarray(js), rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jc), rtol=0, atol=2.4e-7)
    t64 = 2 * np.pi * t.astype(np.float64)
    assert np.abs(sn.numpy() - np.sin(t64)).max() < 1e-6
    assert np.abs(cs.numpy() - np.cos(t64)).max() < 1e-6


def test_sin_cos_turns_quadrant_four_wraps_to_zero():
    """A phase a hair below a whole turn rounds t - floor(t) to exactly
    1.0: u = 4 must wrap to quadrant 0 (sin ~ 0, cos ~ 1), not fall through
    to quadrant 3 (sin -1). Both forms of the hazard: t just below 1, and
    the NCO's phase 2^32 - 1 read as signed (t = -2^-32)."""
    t = torch.tensor([np.nextafter(np.float32(1), np.float32(0)), -2.0**-32,
                      -1e-9, 3.0 - 2**-22], dtype=torch.float32)
    assert float(t[1] - torch.floor(t[1])) == 1.0  # the hazard is real
    sn, cs = mathfns.sin_cos_turns_plain(t)
    assert sn.abs().max() < 1e-5 and (cs - 1).abs().max() < 1e-6
    re, im = sources.nco_planes_plain(0xFFFFFFFF, 0, 0.5, 4, "cpu")
    assert torch.all(re == 0.5) and im.abs().max() < 1e-9
    js, jc = jmath.sin_cos_turns(jnp.asarray(t.numpy()))
    np.testing.assert_allclose(sn.numpy(), np.asarray(js), atol=2.4e-7)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jc), atol=2.4e-7)


_NCO_CASES = [(0, int(round(0.2137 * 2**32)), 0.8),
              (0xFFFFFF00, 0x9E3779B9, 0.5),   # wraps inside the batch
              (0xFFFFFFFF, 0xFFFFFFFF, 0.8)]   # phases at a hair below a turn


@pytest.mark.parametrize("ph0,dp,amp", _NCO_CASES)
def test_nco_planes_plain_matches_pallas_interpret(ph0, dp, amp):
    n = 8192
    jre, jim = jsrc.nco_planes(np.uint32(ph0), np.uint32(dp), np.float32(amp),
                               n=n, interpret=True)
    re, im = sources.nco_planes(ph0, dp, amp, n, "cpu")
    np.testing.assert_allclose(re.numpy(), np.asarray(jre).ravel(), rtol=0,
                               atol=NCO_TOL)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim).ravel(), rtol=0,
                               atol=NCO_TOL)
    # any n: the ragged edge is the same samples
    re7, _ = sources.nco_planes(ph0, dp, amp, 1000, "cpu")
    assert torch.equal(re7, re[:1000])
    assert _launches() == (0, 0, 0, 0)


@pytest.mark.parametrize("ph0,dp,amp", _NCO_CASES)
def test_nco_folded_plain_matches_pallas_and_is_the_folded_planes(ph0, dp, amp):
    R = 64
    jf = jsrc.nco_folded(np.uint32(ph0), np.uint32(dp), np.float32(amp), R=R,
                         interpret=True)
    f = sources.nco_folded(ph0, dp, amp, R, "cpu")
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=NCO_TOL)
    re, im = sources.nco_planes_plain(ph0, dp, amp, 64 * R, "cpu")
    assert torch.equal(f, wbfm_chain.fold_planes(torch.complex(re, im)))
    assert _launches() == (0, 0, 0, 0)


def test_nco_host_helpers_match_reference():
    for f in (1000.0, -123_456.7, 499_999.0, 0.0):
        assert nco.freq_to_dphase(f, FS) == int(jnco.freq_to_dphase(f, FS))
    assert nco.nco_advance(0xFFFFFFF0, 0x10000001, 7) == int(
        jnco.nco_advance(jnp.uint32(0xFFFFFFF0), jnp.uint32(0x10000001), 7))
    ph = nco.nco_phase(0xFFFF0000, 0x12345678, 4096, "cpu")
    jph = jnco.nco_phase(jnp.uint32(0xFFFF0000), jnp.uint32(0x12345678), 4096)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jph))


@pytest.mark.parametrize("waveform", ["complex", "cos", "sin", "square",
                                      "triangle", "saw"])
def test_sig_source_matches_reference(waveform):
    """Two batches through source -> head -> sink in both packages. The
    reference's CPU path is libm sin/cos, the port's the quarter-wave
    polynomial of K8: within 2e-6."""
    n, batch = 2 * 4096, 4096
    dtype = "cf32" if waveform == "complex" else "rf32"

    def run(an, gen, Fg):
        src = an.sig_source(FS, waveform, frequency=TONE, amplitude=0.75,
                            offset=0.125, dtype=dtype)
        hd = gen.head(n, dtype=dtype)
        snk = gen.vector_sink(dtype=dtype)
        fg = Fg(batch_size=batch)
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        return fg, snk

    jfg, jsnk = run(janalog, jgen, JFlowgraph)
    jfg.run()
    tfg, tsnk = run(tanalog, tgen, TFlowgraph)
    tfg.run(device="cpu")
    got, ref = tsnk.data(), np.asarray(jsnk.data())
    assert got.dtype == ref.dtype and got.shape == ref.shape == (n,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    assert _launches() == (0, 0, 0, 0)


# -- the staged chain's ops and blocks ---------------------------------------

def test_rotate_and_quadrature_demod_match_reference():
    x = _cf32(2 * 1024, 5)
    x[:3] = 0  # the zero-history pin
    dp = nco.freq_to_dphase(-FC, FS)
    tst, jst = taops.rotator_init_state("cpu"), jaops.rotator_init_state()
    tq, jq = taops.quad_demod_init_state("cpu"), jaops.quad_demod_init_state()
    for b in range(2):
        xb = x[b * 1024:(b + 1) * 1024]
        tst, ty = taops.rotate(tst, torch.from_numpy(xb), dp, conj=True)
        jst, jy = jaops.rotate(jst, jnp.asarray(xb), jnp.uint32(dp), conj=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6)
        assert tst.phase == int(jst.phase)
        tq, td = taops.quadrature_demod(tq, torch.from_numpy(xb), 0.5)
        jq, jd = jaops.quadrature_demod(jq, jnp.asarray(xb), 0.5)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6)
    assert torch.all(td.new_tensor(0) == taops.quadrature_demod(
        taops.quad_demod_init_state("cpu"), torch.from_numpy(x[:8]), 1.0)[1][:4])


def _block_run(pkg, make, x, batch, out_dtype):
    an = (janalog, jfilt, jgen, JFlowgraph) if pkg == "jax" else \
        (tanalog, tfilt, tgen, TFlowgraph)
    blk = make(*an[:2])
    fg = an[3](batch_size=batch)
    fg.connect(an[2].vector_source(x), 0, blk, 0)
    snk = an[2].vector_sink(dtype=out_dtype)
    fg.connect(blk, 0, snk, 0)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return np.asarray(snk.data())


def test_freq_xlating_fir_matches_reference():
    taps = firdes.low_pass(1.0, FS, 100e3, 30e3)
    x = _cf32(3 * 2560, 6)

    def make(an, filt):
        return filt.freq_xlating_fir(taps, FC, FS, decim=D)

    got = _block_run("torch", make, x, 2560, "cf32")
    ref = _block_run("jax", make, x, 2560, "cf32")
    assert got.shape == ref.shape == (3 * 2560 // D,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("interp,decim,dtype", [(1, 5, "rf32"), (3, 2, "cf32"),
                                                (2, 3, "rf32"), (4, 1, "cf32")])
def test_rational_resampler_matches_reference(interp, decim, dtype):
    """The block, and for interp > 1 the polyphase fir_interp_filter, over
    three batches (state carried) against the reference's."""
    x = _cf32(3 * 1200, 7)
    if dtype == "rf32":
        x = x.real.copy()

    def make(an, filt):
        return filt.rational_resampler(interp, decim, dtype=dtype)

    got = _block_run("torch", make, x, 1200, dtype)
    ref = _block_run("jax", make, x, 1200, dtype)
    assert got.shape == ref.shape == (3 * 1200 * interp // decim,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    if interp > 1:
        taps = firdes.low_pass(interp, 1.0, 0.45 / max(interp, decim),
                               0.1 / max(interp, decim))
        tst = fir.resampler_init_state(len(taps), interp, "cpu", torch.complex64)
        jst = jfir.resampler_init_state(len(taps), interp)
        xc = _cf32(600, 8)
        for b in range(2):
            tst, ty = fir.fir_interp_filter(taps, tst, torch.from_numpy(xc),
                                            interp, decim)
            jst, jy = jfir.fir_interp_filter(taps, jst, jnp.asarray(xc), interp,
                                             decim)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6)
        assert tst.tail.shape == jst.tail.shape


def test_fm_demod_hier_equals_its_two_blocks():
    x = _cf32(2 * 1000, 9)
    quad = FS / D

    def run(hier):
        fg = TFlowgraph(batch_size=1000)
        src = tgen.vector_source(x)
        snk = tgen.vector_sink(dtype="rf32")
        if hier:
            h = tmodels.make_fm_demod_hier(quad)
            fg.connect(src, 0, h, 0)
            fg.connect(h, 0, snk, 0)
        else:
            dm = tanalog.quadrature_demod(gain=quad / (2 * np.pi * DEV))
            rs = tfilt.rational_resampler(1, 5, dtype="rf32")
            fg.connect(src, 0, dm, 0)
            fg.connect(dm, 0, rs, 0)
            fg.connect(rs, 0, snk, 0)
        fg.run(device="cpu")
        return snk.data()

    a, b = run(True), run(False)
    assert a.shape == (400,)
    np.testing.assert_array_equal(a, b)


# -- the fused and live chains (K10, K12) ------------------------------------

def test_wbfm_chain_step_plain_matches_pallas():
    """Three streamed batches of the small chain: the plain version of K10
    against the JAX kernel (interpret, HIGHEST), audio and carry, and
    against the float64 golden."""
    c, rt, dphase, D_, Rd, gain = _small_cfg()
    jplan, tplan = _plans(c, rt, dphase, D_, Rd, gain)
    assert (tplan.B8, tplan.W8, tplan.warm_out) == (jplan.B8, jplan.W8,
                                                    jplan.warm_out)
    consts = wbfm_chain.wbfm_consts(tplan, "cpu")
    n, nb = 64 * 160, 3
    x = _cf32(nb * n, 0)
    jc = jnp.zeros((jplan.B8, 128), jnp.float32)
    tc = torch.zeros(tplan.B8, 128)
    outs = []
    for b in range(nb):
        xb = x[b * n:(b + 1) * n]
        xp = wbfm_chain.fold_planes(torch.from_numpy(xb))
        np.testing.assert_array_equal(
            xp.numpy(), np.asarray(jwc.fold_planes(jnp.asarray(xb))))
        ja, jc = jwc.wbfm_chain_step(jwc.fold_planes(jnp.asarray(xb)), jc,
                                     jplan, interpret=True)
        ta, tc = wbfm_chain.wbfm_chain_step(xp, tc, tplan, consts)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                                   atol=CHAIN_TOL, err_msg=f"batch {b}")
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        outs.append(wbfm_chain.unfold_audio(ta).numpy())
    ref = testing.wbfm_golden(x, c, dphase, D_, rt, Rd, gain)
    got = np.concatenate(outs)
    assert testing.snr_db(ref[:len(got)], got) > 100
    assert _launches() == (0, 0, 0, 0)


def test_wbfm_live_step_plain_matches_pallas_and_nco_folded_chain():
    """Two batches of the live chain from stream start (the first with the
    pre-stream zeros): the plain version of K12 equals K11 -> K10's plain
    versions bit for bit, and agrees with the JAX live kernel."""
    c, rt, dphase, D_, Rd, gain = _small_cfg()
    jplan, tplan = _plans(c, rt, dphase, D_, Rd, gain)
    consts = wbfm_chain.wbfm_consts(tplan, "cpu")
    R, amp = 160, 0.8
    dp = nco.freq_to_dphase(0.21 * FS + 0.02 * FS, FS)
    carry = torch.zeros(tplan.B8, 128)
    ph = 0xFFFFF000  # the counter wraps in the first batch
    for b in range(2):
        live = wbfm_chain.wbfm_chain_live_step(ph, dp, amp, b == 0, tplan,
                                               consts, R)
        xp = sources.nco_folded(ph, dp, amp, R, "cpu")
        two, carry = wbfm_chain.wbfm_chain_step(xp, carry, tplan, consts)
        assert torch.equal(live, two), b
        ja = jwc.wbfm_chain_live_step(np.uint32(ph), np.uint32(dp),
                                      np.float32(amp), b == 0, jplan, R,
                                      interpret=True)
        np.testing.assert_allclose(live.numpy(), np.asarray(ja), rtol=0,
                                   atol=CHAIN_TOL)
        ph = nco.nco_advance(ph, dp, 64 * R)
    assert _launches() == (0, 0, 0, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wbfm_chain_batch_split_property(seed):
    """Random batch partitions of one stream give the one-batch audio bit
    for bit (the junction is rebuilt from raw rows with the same sums), and
    the kernel's tile/segment-group arguments change nothing."""
    c, rt, dphase, D_, Rd, gain = _small_cfg()
    _, plan = _plans(c, rt, dphase, D_, Rd, gain)
    consts = wbfm_chain.wbfm_consts(plan, "cpu")
    rng = np.random.default_rng(100 + seed)
    unit, n_units = 64 * 8 * D_ * Rd, 12
    x = torch.from_numpy(_cf32(n_units * unit, 200 + seed))

    def run(split, **kw):
        carry, outs, pos = torch.zeros(plan.B8, 128), [], 0
        for k in split:
            xp = wbfm_chain.fold_planes(x[pos:pos + k * unit])
            aud, carry = wbfm_chain.wbfm_chain_step(xp, carry, plan, consts, **kw)
            outs.append(wbfm_chain.unfold_audio(aud))
            pos += k * unit
        return torch.cat(outs)

    split, left = [], n_units
    while left:
        split.append(int(rng.integers(1, min(left, 5) + 1)))
        left -= split[-1]
    one = run([n_units])
    assert torch.equal(one, run(split)), split
    assert torch.equal(one, run([n_units], tile=40, seg_group=16))


def test_wbfm_chain_geometry_and_refusals():
    c, rt, dphase, D_, Rd, gain = _small_cfg()
    _, plan = _plans(c, rt, dphase, D_, Rd, gain)
    consts = wbfm_chain.wbfm_consts(plan, "cpu")
    xp, carry = torch.zeros(160, 128), torch.zeros(plan.B8, 128)
    assert wbfm_chain.pick_tile(160, 4, 5) == 160
    assert wbfm_chain.pick_tile(32640, 4, 5) == 2040  # 102 audio rows a block
    g = wbfm_chain._geometry(plan, 160, None, 4)
    assert g.P >= g.GS and g.smem <= wbfm_chain._SMEM_MAX
    with pytest.raises(ValueError, match="tile"):
        wbfm_chain.wbfm_chain_step(xp, carry, plan, consts, tile=30)
    with pytest.raises(ValueError, match="seg_group"):
        wbfm_chain.wbfm_chain_step(xp, carry, plan, consts, seg_group=5)
    with pytest.raises(ValueError, match="carry"):
        wbfm_chain.wbfm_chain_step(xp, carry[:8], plan, consts)
    with pytest.raises(ValueError, match="boundary"):
        wbfm_chain.wbfm_chain_step(torch.zeros(20, 128), carry, plan, consts)
    with pytest.raises(NotImplementedError, match="interp-1"):
        tanalog.wbfm_rcv_fused(np.ones(9), 0.0, FS, resamp_interp=2)
    with pytest.raises(NotImplementedError, match="interp-1"):
        tanalog.wbfm_live_source(np.ones(9), 0.0, FS, resamp_interp=3)
    with pytest.raises(ValueError, match="input_format"):
        tanalog.wbfm_rcv_fused(np.ones(9), 0.0, FS, input_format="planes")
    # deemph_tau appends fm_deemph at the audio rate (1 MS/s / 4 / 5) on
    # every form; tests/test_torch_iir.py holds its output
    for kw in ({}, {"fused": True}, {"fused": True, "source": "live"}):
        _, blks = tmodels.wbfm_receiver(deemph_tau=75e-6, **kw)
        de = blks["deemph"]
        assert isinstance(de, tanalog.fm_deemph), kw
        ff, fb = tiir.lfilter_taps(*tanalog._emphasis_taps(50e3, 75e-6, None,
                                                           True))
        np.testing.assert_array_equal(de.ff, ff)
        np.testing.assert_array_equal(de.fb, fb)
    with pytest.raises(ValueError, match="live"):
        tmodels.wbfm_receiver(source="live")


# -- the receiver at config #1 ------------------------------------------------

def _receiver(kind, batch, nb, **kw):
    """models.wbfm_receiver at config #1 on the exact fixed-point tone at
    TONE: staged, fused (cf32 sig_source or the folded source) or live.
    Returns the audio and the blocks."""
    fused = kind != "staged"
    if kind == "live":
        src = "live"
    elif kind == "folded":
        src = tanalog.sig_source_folded(FS, frequency=TONE)
    else:
        src = tanalog.sig_source(FS, "complex", frequency=TONE)
    fg, blks = tmodels.wbfm_receiver(
        fs=FS, center_freq=FC, quad_rate_decim=D, audio_decim=(1, RD),
        deviation=DEV, source=src, batch_size=batch, sink="vector",
        n_samples=nb * batch // (D * RD), fused=fused, **kw)
    if kind == "live":
        blks["source"].set_frequency(TONE)
    fg.run(device="cpu")
    return blks["sink"].data(), blks


def _golden(n):
    chan_taps = firdes.low_pass(1.0, FS, 100e3, 30e3)
    rt = firdes.low_pass(1.0, 1.0, 0.45 / RD, 0.1 / RD)
    x = testing.fxpt_tone(n, nco.freq_to_dphase(TONE, FS))
    return testing.wbfm_golden(x, chan_taps, nco.freq_to_dphase(FC, FS), D,
                               rt, RD, (FS / D) / (2 * np.pi * DEV))


def test_wbfm_receiver_three_forms_against_golden():
    """Two batches of 40960 samples (R = 640 >= B8 = 568 at the real taps)
    in each form: every one > 100 dB against the float64 golden; the fused
    forms against the staged one > 100 dB; the folded graph and the live
    source bit-equal (K11 -> K10 and K12 share their arithmetic)."""
    batch, nb = 40960, 2
    ref = _golden(nb * batch)
    out = {k: _receiver(k, batch, nb)[0]
           for k in ("staged", "fused", "folded", "live")}
    for kind, got in out.items():
        assert got.shape == (nb * batch // (D * RD),), kind
        assert testing.snr_db(ref[:len(got)], got) > 100, kind
    for kind in ("fused", "folded", "live"):
        assert testing.snr_db(out["staged"], out[kind]) > 100, kind
    np.testing.assert_array_equal(out["folded"], out["live"])
    assert np.abs(out["live"]).max() > 0.3  # (TONE - FC) / DEV = 0.417
    assert _launches() == (0, 0, 0, 0)


def test_wbfm_fused_matches_reference_fused_graph():
    """The fused block on a cf32 FM signal against the JAX package's fused
    graph (interpret mode, HIGHEST), two batches at the real taps."""
    n = 2 * 40960
    t = np.arange(n) / FS
    msg = np.sin(2 * np.pi * 2000.0 * t)
    ph = np.cumsum(2 * np.pi * (DEV / FS) * msg)
    x = (np.exp(1j * ph) * np.exp(2j * np.pi * FC * t)).astype(np.complex64)

    def run(pkg):
        gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
        kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
        fg, blks = models.wbfm_receiver(
            fs=FS, center_freq=FC, quad_rate_decim=D, audio_decim=(1, RD),
            deviation=DEV, source=gen.vector_source(x), batch_size=40960,
            fused=True, **kw)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        return np.asarray(blks["sink"].data())

    got, ref = run("torch"), run("jax")
    assert got.shape == ref.shape == (n // (D * RD),)
    assert testing.snr_db(ref, got) > 120


def test_wbfm_center_freq_retune_relocks():
    """center_freq is a fence parameter: the fused block driven batch by
    batch, set_param between batches rebuilds its plan and constants, and
    the audio re-locks from (TONE - 200 kHz)/DEV to (TONE - 250 kHz)/DEV."""
    batch, nb, at = 61440, 8, 3
    x = torch.from_numpy(np.exp(2j * np.pi * TONE * np.arange(batch * nb) / FS)
                         .astype(np.complex64))
    blk = tanalog.wbfm_rcv_fused(firdes.low_pass(1.0, FS, 100e3, 30e3), FC,
                                 FS, decim=D, deviation=DEV, resamp_decim=RD)
    st, outs = blk.init_state(batch, batch // (D * RD), "cpu"), []
    carry_shape = st["carry"].shape
    for b in range(nb):
        if b == at:
            blk.set_param("center_freq", 250e3)
            assert blk.get_param("center_freq") == 250e3
        st, o = blk.work(st, {"in": x[b * batch:(b + 1) * batch]},
                         blk.param_leaves("cpu"), batch // (D * RD))
        assert st["carry"].shape == carry_shape
        outs.append(o["out"].numpy())
    got = np.concatenate(outs)
    a1, a2 = (TONE - 200e3) / DEV, (TONE - 250e3) / DEV
    sw = at * batch // (D * RD)
    assert np.all(np.abs(got[256:sw] - a1) < 5e-3)
    assert np.all(np.abs(got[sw + 256:] - a2) < 5e-3)


def test_wbfm_states_from_jax_hand_over_at_batch_two():
    """JAX runs batch one of the staged, fused and live small chains; the
    converted states (NCO phase, rotator phase, FIR tails, demod prev,
    resampler tail, fused carry, live phase and first flag) carry the
    port's batch two to JAX's."""
    c, rt, dphase, D_, Rd, gain = _small_cfg()
    center, tone, n = 0.21 * FS, 0.23 * FS, 64 * 160

    def graphs(pkg):
        an, filt, gen, Fg = ((janalog, jfilt, jgen, JFlowgraph) if pkg == "jax"
                             else (tanalog, tfilt, tgen, TFlowgraph))
        kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
        chain = dict(decim=D_, deviation=DEV, resamp_decim=Rd, resamp_taps=rt)
        out = {}
        fg = Fg()
        blocks = [an.sig_source(FS, "complex", frequency=tone, name="src"),
                  filt.freq_xlating_fir(c, center, FS, decim=D_, name="xlate"),
                  an.quadrature_demod(gain=gain, name="demod"),
                  filt.rational_resampler(1, Rd, taps=rt, dtype="rf32",
                                          name="resamp"),
                  gen.vector_sink(dtype="rf32", name="snk")]
        for a, b in zip(blocks, blocks[1:]):
            fg.connect(a, 0, b, 0)
        out["staged"] = (fg, n)
        fg = Fg()
        fused = an.wbfm_rcv_fused(c, center, FS, name="fused", **chain, **kw)
        fg.connect(an.sig_source(FS, "complex", frequency=tone, name="src"), 0,
                   fused, 0)
        fg.connect(fused, 0, gen.vector_sink(dtype="rf32", name="snk"), 0)
        out["fused"] = (fg, n)
        fg = Fg()
        fg.connect(an.wbfm_live_source(c, center, FS, frequency=tone,
                                       name="live", **chain, **kw), 0,
                   gen.vector_sink(dtype="rf32", name="snk"), 0)
        out["live"] = (fg, n // (D_ * Rd))
        return out

    jg, tg = graphs("jax"), graphs("torch")
    for kind in ("staged", "fused", "live"):
        jfg, ref_items = jg[kind]
        tfg, _ = tg[kind]
        jcfg = jcompile(jfg, batch_size=ref_items)
        tcfg = tcompile(tfg, batch_size=ref_items)
        jparams = jcfg.init_params()
        s1, _ = jcfg.step(jcfg.init_states(), jparams)
        _, out2 = jcfg.step(s1, jparams)
        states = convert.states_from_jax(jax.device_get(s1), "cpu")
        tparams = {b.name: b.param_leaves("cpu") for b in tcfg.order}
        _, tout = tcfg.step(states, tparams)
        got, ref = tout["snk"].numpy(), np.asarray(out2["snk"])
        assert got.shape == ref.shape == (n // (D_ * Rd),), kind
        # the staged graph's sin/cos and atan2 are libm on both sides; the
        # fused chains' the polynomial ones
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5, err_msg=kind)
        assert np.abs(got).max() > 0.1, kind
        if kind == "staged":
            assert states["src"]["phase"].dtype == torch.int64
            assert int(states["src"]["phase"]) == nco.nco_advance(
                0, nco.freq_to_dphase(tone, FS), n)
            assert isinstance(states["xlate"]["rot"], taops.RotatorState)
            assert states["xlate"]["rot"].phase.dtype == torch.int64
            assert isinstance(states["xlate"]["fir"], fir.FirState)
            assert isinstance(states["demod"], taops.QuadDemodState)
            assert isinstance(states["resamp"], fir.FirState)
        elif kind == "live":
            first = states["live"]["first"]
            assert first.dtype == torch.bool and not bool(first)
    assert _launches() == (0, 0, 0, 0)


def test_entry_points_default_to_the_card():
    """Flowgraph.run and the Runner it builds run on the card unless the
    caller asks for the CPU (no test here can run the default)."""
    assert inspect.signature(TFlowgraph.run).parameters["device"].default == "cuda"
    assert inspect.signature(Runner).parameters["device"].default == "cuda"
