"""Config #0, the FIR chain, on the CPU: the ``fir_filter`` block (all its
methods, "mxu3" included), the live filtered tone (kernel K9
``fir_tone_step``, plain version) and its ``fir_tone_source``,
``models.fir_chain`` in its staged and live forms, and the pipelined form
of the fused channelizer chain (kernel K3p, ``fm_chain_step_planes(
pipelined=True)``), each held against the JAX package on the same numpy
inputs (Pallas in interpret mode, at HIGHEST precision where the reference
offers it) and against the float64 golden. CUDA is never built here: every
launch count stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu import models as jmodels
from newsched_tpu.blocks import analog as janalog, filter as jfilt, \
    general as jgen
from newsched_tpu.ops import firdes as jfirdes, pfb as jpfb
from newsched_tpu.ops.pallas import fir_source as jfs, fm_chain as jfm
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import convert, models as tmodels, testing
from newsched_tpu_torch.blocks import analog as tanalog, filter as tfilt, \
    general as tgen
from newsched_tpu_torch.ops import fir, firdes, nco
from newsched_tpu_torch.ops.cuda import fir_source, fm_chain, sources
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

HIGHEST = jax.lax.Precision.HIGHEST
FS, FREQ, NTAPS = 1e6, 123_456.0, 128
K9_TOL = 1e-5  # plain vs the Pallas kernel, relative to max|out|: 128-term
#                sums in another order, and XLA's FMA-contracted NCO
GATE_DB = 100.0  # tests/test_models.py's bar for the live chain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taps(ntaps=NTAPS):
    return firdes.low_pass(1.0, FS, 0.2 * FS, 0.05 * FS, ntaps=ntaps)


def _launches():
    return (fir_source.fir_tone_step.launches, sources.nco_planes.launches,
            fm_chain.fm_chain_step_planes.launches,
            fm_chain.fm_chain_step_planes.pipe_launches)


# -- K9: the live filtered tone ------------------------------------------------

# (start phase, decim): a start that wraps inside the batch, one whose
# negative indices wrap below zero, and config #0's tone from phase 0
_K9_CASES = [(0xFFFFF000, 1), (0x00000100, 4), (0, 1), (0x80000000, 4)]


@pytest.mark.parametrize("ph0,D", _K9_CASES)
def test_fir_tone_step_plain_matches_pallas(ph0, D):
    """A first and a later batch (the first masks the pre-stream samples
    to 0, the later reads them from the previous batch through the uint32
    wrap) against the reference kernel in interpret mode."""
    R, amp = 256, 0.8
    taps = _taps()
    dp = nco.freq_to_dphase(FREQ, FS)
    tt = torch.from_numpy(taps.astype(np.float32))
    for first in (True, False):
        got = fir_source.fir_tone_step(ph0, dp, amp, first, tt, D, R)
        ref = np.asarray(jfs.fir_tone_step(
            np.uint32(ph0), np.uint32(dp), np.float32(amp), int(first), taps,
            D, R, precision=HIGHEST, interpret=True))
        assert got.shape == ref.shape == (R // D, 128)
        scale = np.abs(ref).max()
        err = np.abs(got.numpy() - ref).max()
        assert err <= K9_TOL * scale, (first, err, scale)
        assert testing.snr_db(ref, got.numpy()) >= GATE_DB
    assert torch.equal(fir_source.unfold_complex(got),
                       torch.complex(got[:, :64].T.reshape(-1),
                                     got[:, 64:].T.reshape(-1)))
    assert _launches() == (0, 0, 0, 0)


def test_fir_tone_step_is_the_filtered_nco_folded_stream():
    """The plain version is the NCO's folded tone filtered tap by tap: the
    same as filtering the unfolded stream of two batches with
    ops/fir.py's conv path (decimating by 4)."""
    R, D, amp = 128, 4, 0.5
    taps = _taps(65).astype(np.float32)
    dp = nco.freq_to_dphase(FREQ, FS)
    tt = torch.from_numpy(taps)
    x = torch.cat([fir_source.unfold_complex(sources.nco_folded(
        nco.nco_advance(0, dp, b * 64 * R), dp, amp, R, "cpu")) for b in range(2)])
    _, ref = fir.fir_filter(taps, fir.fir_init_state(65, "cpu"), x, decim=1,
                            method="conv")
    for b in range(2):
        got = fir_source.fir_tone_step(nco.nco_advance(0, dp, b * 64 * R), dp,
                                       amp, b == 0, tt, D, R)
        seg = ref[b * 64 * R:(b + 1) * 64 * R].reshape(64, R)[:, ::D].reshape(-1)
        np.testing.assert_allclose(fir_source.unfold_complex(got).numpy(),
                                   seg.numpy(), rtol=0, atol=2e-6)


def test_fir_tone_geometry_and_refusals():
    tt = torch.from_numpy(_taps().astype(np.float32))
    assert fir_source.pick_tile(32768, 1) == 512
    assert fir_source.pick_tile(256, 4) == 256
    g = fir_source._geometry(32768, 1, NTAPS, None, fir_source.SEG_GROUP)
    assert (g.T, g.GS, g.NQ) == (512, 8, 4) and g.smem <= fir_source._SMEM_MAX
    with pytest.raises(ValueError, match="tile"):
        fir_source.fir_tone_step(0, 1, 1.0, True, tt, 1, 256, tile=96)
    with pytest.raises(ValueError, match="decim"):
        fir_source.fir_tone_step(0, 1, 1.0, True, tt, 3, 256)
    with pytest.raises(ValueError, match="shared memory"):
        fir_source._geometry(32768, 64, NTAPS, 32768, fir_source.SEG_GROUP)


# -- the blocks ----------------------------------------------------------------

def _fir_taps(kind, ntaps=33):
    t = firdes.low_pass(1.0, 1.0, 0.2, 0.05, ntaps=ntaps)
    if kind == "complex":
        t = (t * np.exp(0.3j * np.arange(ntaps))).astype(np.complex64)
    return t


def _run_block(pkg, taps, decim, dtype, method, x, batch):
    gen, filt, Fg = ((jgen, jfilt, JFlowgraph) if pkg == "jax"
                     else (tgen, tfilt, TFlowgraph))
    fg = Fg(batch_size=batch)
    blk = filt.fir_filter(taps, decim=decim, dtype=dtype, method=method)
    snk = gen.vector_sink(dtype=dtype)
    fg.connect(gen.vector_source(x), 0, blk, 0)
    fg.connect(blk, 0, snk, 0)
    fg.run() if pkg == "jax" else fg.run(device="cpu")
    return np.asarray(snk.data())


@pytest.mark.parametrize("method", ["auto", "mxu", "conv", "mxu3"])
@pytest.mark.parametrize("kind,dtype", [("real", "cf32"), ("complex", "cf32"),
                                        ("real", "rf32")])
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_filter_block_matches_reference(method, kind, dtype, decim):
    """Three batches with the carried tail against the reference block;
    "mxu3" is the reference's bf16x3 tier and the port's FP32 product, so
    the two agree to that tier's error (~1e-6 of the output's scale)."""
    rng = np.random.default_rng(decim)
    n, batch = 3 * 1024, 1024
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = (x.real if dtype == "rf32" else x).astype(
        np.float32 if dtype == "rf32" else np.complex64)
    taps = _fir_taps(kind)
    got = _run_block("torch", taps, decim, dtype, method, x, batch)
    ref = _run_block("jax", taps, decim, dtype, method, x, batch)
    assert got.shape == ref.shape == (n // decim,)
    assert got.dtype == ref.dtype
    tol = (3e-5 if method == "mxu3" else 2e-6) * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_fir_tone_source_matches_staged_blocks_and_refuses():
    """fir_tone_source(decim=4) equals sig_source -> fir_filter(decim=4)
    to float32 accuracy, over three batches; its refusals."""
    taps = _taps(65)
    n, batch, D = 3 * 4096, 4096, 4

    def run(live):
        fg = TFlowgraph(batch_size=batch // D if live else batch)
        hd, snk = tgen.head(n // D), tgen.vector_sink()
        if live:
            fg.connect(tanalog.fir_tone_source(FS, taps, frequency=FREQ,
                                               amplitude=0.7, decim=D), 0, hd, 0)
        else:
            fir_blk = tfilt.fir_filter(taps, decim=D)
            fg.connect(tanalog.sig_source(FS, "complex", frequency=FREQ,
                                          amplitude=0.7), 0, fir_blk, 0)
            fg.connect(fir_blk, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        fg.run(device="cpu")
        return snk.data()

    live, staged = run(True), run(False)
    assert live.shape == staged.shape == (n // D,)
    assert testing.snr_db(staged, live) > GATE_DB
    with pytest.raises(ValueError, match="real taps"):
        tanalog.fir_tone_source(FS, taps.astype(np.complex64))
    src = tanalog.fir_tone_source(FS, taps, decim=D)
    with pytest.raises(ValueError, match="fold width"):
        src.work(src.init_state(0, 40, "cpu"), {}, src.param_leaves("cpu"), 40)
    with pytest.raises(ValueError, match="decim"):  # 64 samples, R % D != 0
        src.work(src.init_state(0, 16, "cpu"), {}, src.param_leaves("cpu"), 16)
    # the "fft" method (config #3's overlap-save filter) equals the
    # reference's, two batches with the carried tail
    xf = np.random.default_rng(2).standard_normal(512).astype(np.complex64)
    got = _run_block("torch", taps, 1, "cf32", "fft", xf, 256)
    ref = _run_block("jax", taps, 1, "cf32", "fft", xf, 256)
    assert got.shape == ref.shape == (512,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    assert _launches() == (0, 0, 0, 0)


# -- the model -----------------------------------------------------------------

def _chain(pkg, source, n, batch):
    if pkg == "jax":
        fg, b = jmodels.fir_chain(n_samples=n, fs=FS, ntaps=NTAPS, frequency=FREQ,
                                  batch_size=batch, sink="vector", source=source,
                                  interpret=True)
        fg.run()
    else:
        fg, b = tmodels.fir_chain(n_samples=n, fs=FS, ntaps=NTAPS, frequency=FREQ,
                                  batch_size=batch, sink="vector", source=source)
        fg.run(device="cpu")
    return np.asarray(b["sink"].data()), b


def test_fir_chain_staged_and_live_against_golden_and_reference():
    """Both forms over 62,536 samples in batches of 8192, the last cut by
    the head: > 100 dB against the float64 golden, live against staged
    > 100 dB (tests/test_models.py's bars), and each against the
    reference's own form > 100 dB (its staged filter is the bf16x3 tier),
    which itself reads > 100 dB against the golden."""
    n, batch = (1 << 16) - 3000, 8192
    out = {}
    for source in (None, "live"):
        got, b = _chain("torch", source, n, batch)
        assert got.shape == (n,) and got.dtype == np.complex64
        ref = testing.fir_golden(n, b["taps"], FREQ, FS)
        assert testing.snr_db(ref, got) > GATE_DB, source
        jgot, jb = _chain("jax", source, n, batch)
        np.testing.assert_array_equal(b["taps"], jb["taps"])
        assert testing.snr_db(jgot, got) > GATE_DB, source
        # the reference's staged form far above the 61.7 dB its TPU
        # lowering reads (BENCH_r05): that gap is the TPU's, not the graph's
        assert testing.snr_db(ref, jgot) > GATE_DB, source
        out[source] = got
    assert testing.snr_db(out[None], out["live"]) > GATE_DB
    assert isinstance(b["src"], tanalog.fir_tone_source) and b["fir"] is b["src"]
    assert _launches() == (0, 0, 0, 0)


def test_fir_chain_live_batch_split_is_bit_exact():
    """Two batches of 4096 equal one of 8192 bit for bit: every output is
    the same sum of the same generated samples (a segment's look-back
    reaches two segments back at R = 64 rows)."""
    n = 2 * 8192
    one, _ = _chain("torch", "live", n, 8192)
    two, _ = _chain("torch", "live", n, 4096)
    np.testing.assert_array_equal(one, two)


def test_fir_chain_states_from_jax_hand_over_at_batch_two():
    """JAX runs batch one of the staged (sig_source -> fir_filter) and live
    (fir_tone_source) chains; the converted states (NCO phase, FIR tail,
    live phase and first flag) carry the port's batch two to JAX's."""
    taps, n = _taps(), 8192

    def graph(pkg, live):
        an, filt, gen, Fg = ((janalog, jfilt, jgen, JFlowgraph) if pkg == "jax"
                             else (tanalog, tfilt, tgen, TFlowgraph))
        kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
        fg = Fg()
        snk = gen.vector_sink(name="snk")
        if live:
            fg.connect(an.fir_tone_source(FS, taps, frequency=FREQ, name="live",
                                          **kw), 0, snk, 0)
        else:
            fir_blk = filt.fir_filter(taps, name="fir")
            fg.connect(an.sig_source(FS, "complex", frequency=FREQ, name="src"),
                       0, fir_blk, 0)
            fg.connect(fir_blk, 0, snk, 0)
        return fg

    for live in (False, True):
        jcfg = jcompile(graph("jax", live), batch_size=n)
        tcfg = tcompile(graph("torch", live), batch_size=n)
        jparams = jcfg.init_params()
        s1, _ = jcfg.step(jcfg.init_states(), jparams)
        _, out2 = jcfg.step(s1, jparams)
        states = convert.states_from_jax(jax.device_get(s1), "cpu")
        tparams = {b.name: b.param_leaves("cpu") for b in tcfg.order}
        _, tout = tcfg.step(states, tparams)
        got, ref = tout["snk"].numpy(), np.asarray(out2["snk"])
        assert got.shape == ref.shape == (n,)
        # the staged sig_source: libm sin/cos in the reference, the
        # quarter-wave polynomial here
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        phase = nco.nco_advance(0, nco.freq_to_dphase(FREQ, FS), n)
        if live:
            # the on-card forms: the uint32 phase as an int64, the flag a bool
            st = states["live"]
            assert st["phase"].dtype == torch.int64 and int(st["phase"]) == phase
            assert st["first"].dtype == torch.bool and not bool(st["first"])
        else:
            assert isinstance(states["fir"], fir.FirState)
            assert states["fir"].tail.shape == (NTAPS - 1,)
            assert states["src"]["phase"].dtype == torch.int64
            assert int(states["src"]["phase"]) == phase
    assert _launches() == (0, 0, 0, 0)


# -- K3p: the pipelined fused channelizer chain ----------------------------------

def test_fm_chain_pipelined_plan_fits_the_card():
    """K3p's plan (csrc/fm_chain.cu pipe_smem_floats): a block of a
    producer warp, 4 fold and 8 demod warps; its shared memory at the
    flagship's taps (L = 16, A = 65) is two Y slots of max(tile, A) rows
    padded to 32, two windows of 32 + L-1 rows, the ring of A-1+tile aud
    rows, two Y rows and the audio taps: within the H100's 227 KB a block at tiles 64 and
    128, one block an SM, so the batch's 32768 rows take 4 and 2 tiles a
    block on 132 SMs; tile 256 passes the block's memory and is refused
    before any launch."""
    W, A, L = 128, 65, 16
    assert fm_chain._PIPE_THREADS == 32 + 128 + 256
    assert fm_chain._PIPE_THREADS % 32 == 0 and fm_chain._PIPE_STAGES == 2
    for tile, slot, G in ((64, 96, 4), (128, 128, 2)):
        smem = fm_chain._pipe_smem(tile, A, L, W)
        assert smem == 4 * (16 + 2 * slot * W + 2 * (32 + L - 1) * W
                            + (A - 1 + tile) * W // 2 + 2 * W + A)
        assert smem <= fm_chain._SMEM_MAX
        assert fm_chain._SM_SMEM // (smem + 1024) == 1
        assert fm_chain._pipe_tiles_per_block(32768 // tile, smem, 132) == G
    assert fm_chain._pipe_smem(64, A, L, W) == 180288 + 4 * A
    assert fm_chain._pipe_smem(128, A, L, W) == 229440 + 4 * A
    assert fm_chain._pipe_smem(256, A, L, W) > fm_chain._SMEM_MAX
    meta = dict(device="meta", dtype=torch.float32)
    consts = fm_chain.FmChainConsts(*(torch.empty(s, **meta) for s in (
        (L, W), (W, W), (A,), (4, W // 2))))
    with pytest.raises(ValueError, match="tile 256"):
        fm_chain._pipe(torch.empty(1024, W, **meta),
                       torch.empty(16, W, **meta),
                       torch.empty(1, W, **meta), torch.empty(A - 1, W, **meta),
                       consts, 8, 1.0, 256, None)


def test_fm_chain_pipelined_matches_unpipelined_and_reference():
    """Two batches of 512 rows at tile 128 with carried state: the
    pipelined call equals the unpipelined one bit for bit, and both are
    within K3's tolerance of the reference's pipelined kernel (interpret,
    HIGHEST), audio, prev and tail."""
    M, L, A, decim, n = 64, 16, 65, 8, 512
    rng = np.random.default_rng(9)
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    H8 = fm_chain._round8(L - 1)
    jstate = (np.zeros((H8, 2 * M), np.float32), jnp.zeros((1, 2 * M)),
              jnp.zeros((A - 1, 2 * M)))
    tstate = {p: (torch.zeros(H8, 2 * M), torch.zeros(1, 2 * M),
                  torch.zeros(A - 1, 2 * M)) for p in (False, True)}
    for b in range(2):
        vb = (rng.standard_normal((n, 2 * M)) * 0.5).astype(np.float32)
        outs = {}
        for p in (False, True):
            halo, prev, tail = tstate[p]
            outs[p] = fm_chain.fm_chain_step_planes(
                torch.from_numpy(vb), halo, prev, tail, consts, decim, 0.7,
                tile=128, pipelined=p)
            tstate[p] = (torch.from_numpy(vb[-H8:].copy()), *outs[p][1:])
        assert all(torch.equal(x, y) for x, y in zip(outs[False], outs[True]))
        halo, prev, tail = jstate
        ref = jfm.fm_chain_step_planes(
            jnp.asarray(vb), jnp.asarray(halo), prev, tail, fold_c, ataps,
            decim, 0.7, tile=128, interpret=True, pipelined=True,
            precision=HIGHEST)
        jstate = (vb[-H8:], ref[1], ref[2])
        for name, x, y in zip(("audio", "prev", "tail"), outs[True], ref):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-4,
                                       atol=2e-5, err_msg=f"{name} batch {b}")
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of 32"):
        fm_chain.fm_chain_step_planes(z(480, 2 * M), z(H8, 2 * M), z(1, 2 * M),
                                      z(A - 1, 2 * M), consts, decim, 0.7,
                                      tile=80, pipelined=True)
    assert _launches() == (0, 0, 0, 0)


def test_k3p_split_cuts_find_their_anchors():
    """``probes/stages.py k3p --split`` cuts K3p's fold group and demod
    group (``csrc/fm_chain.cu``) at anchors that must each be there once,
    each behind its macro."""
    from newsched_tpu_torch.ops.cuda import _build
    from newsched_tpu_torch.probes import stages

    text = (_build.CSRC / "fm_chain.cu").read_text()
    for macro, anchors in stages._K3P_CUTS.items():
        for anchor, pre, post in anchors:
            assert text.count(anchor) == 1, macro
        assert any(macro in pre + post for _, pre, post in anchors)
    assert {m for _, ms in stages._K3P_VARIANTS for m in ms} == set(
        stages._K3P_CUTS)
