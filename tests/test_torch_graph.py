"""Stream state on the card and the runner's graph mode, on the CPU.

Every piece of stream state is a device tensor that the step advances: the
NCO phases wrap past 2^32 as the reference's uint32 phase does, the noise
group counter crosses 2^32 and goes below 0 as the reference's
``add_groups_signed`` does, and ``convert`` hands the reference's states and
parameters over in those forms. The runner's graph mode (the reference's
scan mode: a captured CUDA graph of a chunk of steps on the card) runs its
chunk, remainder and stacking bookkeeping on the CPU with the step called
directly, and delivers what the loop delivers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.blocks import analog as janalog, filter as jfilt, \
    general as jgen
from newsched_tpu.ops import nco as jnco
from newsched_tpu.ops.pallas import noise as jnoise
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import convert, models as tmodels
from newsched_tpu_torch.blocks import analog as tanalog, filter as tfilt, \
    general as tgen, vector_dsp as tvd
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import noise
from newsched_tpu_torch.runtime import runner as trunner
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

HIGHEST = jax.lax.Precision.HIGHEST
FS = 1e6
TOL = 2e-5  # port vs reference outputs: polynomial vs libm sin/cos, FP32
C = trunner.GRAPH_CHUNK
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_chain():
    """tests/test_wbfm_fused.py's small receiver: 25 channel taps, 15
    resampler taps, D = 4, Rd = 5."""
    return sig.firwin(25, 0.2), sig.firwin(15, 0.15), 4, 5


def _graph(pkg, kind, tone):
    """A small graph of one NCO source on either package: "sig_source"
    (-> vector_sink), "fused"/"staged" receiver around a sig_source, "live"
    (wbfm_live_source), "fir" (sig_source -> fir_filter) or "fir live"
    (fir_tone_source); returns (graph, reference items a batch, the
    block whose phase is checked)."""
    an, filt, gen, Fg = ((janalog, jfilt, jgen, JFlowgraph) if pkg == "jax"
                         else (tanalog, tfilt, tgen, TFlowgraph))
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    c, rt, D, Rd = _small_chain()
    chain = dict(decim=D, deviation=75e3, resamp_decim=Rd, resamp_taps=rt)
    center, n = 0.21 * FS, 64 * 160
    taps = firdes.low_pass(1.0, FS, 0.2 * FS, 0.05 * FS, ntaps=128)
    fg = Fg()
    src = an.sig_source(FS, "complex", frequency=tone, name="src")
    if kind == "sig_source":
        fg.connect(src, 0, gen.vector_sink(name="snk"), 0)
    elif kind == "staged":
        blocks = [src, filt.freq_xlating_fir(c, center, FS, decim=D,
                                             name="xlate"),
                  an.quadrature_demod(gain=0.7, name="demod"),
                  filt.rational_resampler(1, Rd, taps=rt, dtype="rf32",
                                          name="resamp"),
                  gen.vector_sink(dtype="rf32", name="snk")]
        for a, b in zip(blocks, blocks[1:]):
            fg.connect(a, 0, b, 0)
    elif kind == "fused":
        fused = an.wbfm_rcv_fused(c, center, FS, name="fused", **chain, **kw)
        fg.connect(src, 0, fused, 0)
        fg.connect(fused, 0, gen.vector_sink(dtype="rf32", name="snk"), 0)
    elif kind == "live":
        src = an.wbfm_live_source(c, center, FS, frequency=tone, name="src",
                                  **chain, **kw)
        fg.connect(src, 0, gen.vector_sink(dtype="rf32", name="snk"), 0)
        return fg, n // (D * Rd), src
    elif kind == "fir":
        fir_blk = filt.fir_filter(taps, name="fir")
        fg.connect(src, 0, fir_blk, 0)
        fg.connect(fir_blk, 0, gen.vector_sink(name="snk"), 0)
    else:  # "fir live"
        src = an.fir_tone_source(FS, taps, frequency=tone, name="src", **kw)
        fg.connect(src, 0, gen.vector_sink(name="snk"), 0)
    return fg, n, src


# -- stream state on the card ----------------------------------------------

@pytest.mark.parametrize("kind", ["sig_source", "live", "fir live"])
def test_nco_phase_wraps_past_2_32_as_the_reference(kind):
    """A tone at 0.93 of the sample rate wraps the uint32 phase many times
    a batch: over three batches the port's phase (an int64 tensor on the
    device) equals the reference's uint32 phase after every batch, and the
    outputs agree."""
    tone = 0.93 * FS
    jfg, n, _ = _graph("jax", kind, tone)
    tfg, _, _ = _graph("torch", kind, tone)
    jcfg, tcfg = jcompile(jfg, batch_size=n), tcompile(tfg, batch_size=n)
    js, jp = jcfg.init_states(), jcfg.init_params()
    ts, tp = tcfg.init_states("cpu"), tcfg.init_params("cpu")
    dp = int(nco_dphase := jnco.freq_to_dphase(tone, FS))
    assert tp["src"]["dphase"].dtype == torch.int64
    assert int(tp["src"]["dphase"]) == dp
    samples = 0
    for b in range(3):
        js, jout = jcfg.step(js, jp)
        ts, tout = tcfg.step(ts, tp)
        ph = ts["src"]["phase"]
        assert ph.dtype == torch.int64 and ph.shape == ()
        assert int(ph) == int(np.asarray(js["src"]["phase"])), (kind, b)
        samples += n if kind != "live" else n * 20
        assert int(ph) == (samples * int(nco_dphase)) & 0xFFFFFFFF
        np.testing.assert_allclose(tout["snk"].numpy(), np.asarray(jout["snk"]),
                                   rtol=0, atol=TOL, err_msg=f"{kind} {b}")
    if kind != "sig_source":
        assert ts["src"]["first"].dtype == torch.bool
        assert not bool(ts["src"]["first"])


@pytest.mark.parametrize("hi, lo, off", [
    (0, -2, 5),                # the low word wraps: across 2^32
    (0, 3, -5),                # below 0: the signed pre-stream region
    (-1, -1, 1),               # -1 + 1 = 0
    (1, 0, -1),                # back across 2^32
    (0x7FFFFFFF, -1, 1),       # the wrap at 2^64 (signed: 2^63 - 1 + 1)
    (-2**31, 0, -1),           # and back
    (5, 2**31 - 1, 1 << 20),   # a large step
])
def test_group_counter_advances_as_add_groups_signed(hi, lo, off):
    """The sources' one int64 counter, advanced on the device, holds the
    64 bits the reference's (hi, lo) int32 pair holds after
    add_groups_signed, wrap and sign included; the rows at the advanced
    counter equal the rows at the reference's pair."""
    g = noise.advance(noise.group_tensor(noise.group64(hi, lo), "cpu"), off)
    jhi, jlo = jnoise.add_groups_signed(jnp.int32(hi), jnp.int32(lo), off)
    assert g.dtype == torch.int64
    assert int(g) == noise.group64(int(jhi), int(jlo))
    assert (int(jhi), int(jlo)) == noise.add_groups_signed(hi, lo, off)
    kw = dict(n_rows=128, width=16, seed=3, device="cpu", mask_pre=True,
              row0=-64)
    assert torch.equal(noise.gaussian_rows_plain(g, **kw),
                       noise.gaussian_rows_plain(
                           noise.group64(int(jhi), int(jlo)), **kw))


def test_noise_source_counter_crosses_2_32_on_the_device():
    """noise_planes_source started two groups below 2^32: its counter after
    each batch is the reference's advance_groups, its rows the stream's."""
    blk = tvd.noise_planes_source(64, amplitude=0.5, seed=2)
    st = {"group": noise.group_tensor(noise.group64(0, -2), "cpu")}
    params = blk.param_leaves("cpu")
    hi, lo = 0, -2
    for _ in range(3):
        g0 = int(st["group"])
        st, out = blk.work(st, {}, params, 128)
        hi, lo = (int(v) for v in jnoise.add_groups_signed(
            jnp.int32(hi), jnp.int32(lo), 128 // noise.GROUP_ROWS))
        assert int(st["group"]) == noise.group64(hi, lo)
        assert torch.equal(out["out"], noise.gaussian_rows_plain(
            g0, n_rows=128, width=128, seed=2, device="cpu") * 0.5)
    assert int(st["group"]) == (1 << 32) + 4


@pytest.mark.parametrize("kind", ["staged", "fused", "live", "fir",
                                  "fir live"])
def test_convert_gives_the_on_card_forms(kind):
    """The reference's initial states and parameters, converted, are the
    port's own in structure, dtype and value (``dphase`` an int64,
    ``center_freq`` a float64, not the reference's uint32 and host float;
    phases int64, flags bool), and a step on them is bit-equal to a step on
    the port's own init_states()/init_params()."""
    tone = 0.23 * FS
    jfg, n, _ = _graph("jax", kind, tone)
    tfg, _, _ = _graph("torch", kind, tone)
    jcfg, tcfg = jcompile(jfg, batch_size=n), tcompile(tfg, batch_size=n)
    params = convert.params_from_jax(jax.device_get(jcfg.init_params()), "cpu")
    states = convert.states_from_jax(jax.device_get(jcfg.init_states()), "cpu")
    own_p, own_s = tcfg.init_params("cpu"), tcfg.init_states("cpu")
    for b, p in own_p.items():
        assert set(params[b]) == set(p), b
        for k, v in p.items():
            assert params[b][k].dtype == v.dtype, (b, k)
            assert torch.equal(params[b][k], v), (b, k)
    got_s, own = _keyed(states), _keyed(own_s)
    assert got_s.keys() == own.keys()
    for k, t in own.items():
        assert got_s[k].dtype == t.dtype and torch.equal(got_s[k], t), k
    _, out = tcfg.step(states, params)
    _, ref = tcfg.step(own_s, own_p)
    assert torch.equal(out["snk"], ref["snk"])


def _keyed(tree, path=()) -> dict:
    """A state tree's tensors by their path of keys and field names."""
    if isinstance(tree, torch.Tensor):
        return {path: tree}
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    return {k: v for key, sub in items for k, v in _keyed(sub, path + (key,))
            .items()}


def test_tag_refusal_points_at_the_tag_plane():
    class tagged(tgen.vector_source):
        tag_capacity = 4

    fg = TFlowgraph(batch_size=64)
    fg.connect(tagged(np.zeros(64, np.float32)), 0,
               tgen.null_sink(dtype="rf32"), 0)
    with pytest.raises(NotImplementedError,
                       match=r"tag plane, runtime/tags\.py, is ROADMAP Queue 1 "
                             r"item 4"):
        tcompile(fg, batch_size=64)


# -- the runner's graph mode, its bookkeeping on the CPU ---------------------

def _model_graphs():
    """Small versions of the model graphs: (name, builder(n_batches))."""
    M, A, decim, rows = 64, 65, 8, 256
    at = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    rng = np.random.default_rng(1)
    prow = rng.standard_normal((rows, 2 * M)).astype(np.float32)

    def channelizer(source, fused=True, **kw):
        def build(nb):
            src = tgen.vector_source(prow, repeat=True) if source == "replay" \
                else source
            return tmodels.fm_channelizer(
                nchans=M, taps_per_arm=16, audio_decim=decim, fused=fused,
                source=src, batch_size=rows * M, sink="vector",
                n_samples=nb * rows // decim - 3, audio_taps=at, **kw)
        return build

    def receiver(kind):
        def build(nb):
            src = {"live": "live", "folded": tanalog.sig_source_folded(
                FS, frequency=231_250.0)}.get(kind)
            if src is None:
                src = tanalog.sig_source(FS, "complex", frequency=231_250.0)
            return tmodels.wbfm_receiver(
                source=src, batch_size=WB_BATCH, sink="vector",
                fused=kind != "staged", n_samples=nb * WB_BATCH // 20 - 5)
        return build

    def fir(kind):
        def build(nb):
            return tmodels.fir_chain(n_samples=nb * 4096 - 100,
                                     batch_size=4096, sink="vector",
                                     source="live" if kind == "live" else None)
        return build

    return {"fused replay": channelizer("replay"),
            "fused noise": channelizer(None),
            "staged": channelizer(None, fused=False),
            "live": channelizer("live"),
            "wbfm staged": receiver("staged"), "wbfm fused": receiver("fused"),
            "wbfm folded": receiver("folded"), "wbfm live": receiver("live"),
            "fir staged": fir("staged"), "fir live": fir("live")}


WB_BATCH = 64 * 20 * 30  # the receiver's smallest batch over its 568-row junction
GRAPHS = _model_graphs()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_no_stream_state_is_a_host_int(name):
    """Every graph's states and parameters are tensors: nothing a captured
    step would bake in."""
    fg, _ = GRAPHS[name](2)
    r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
    assert trunner._tensors(r.init_states())  # raises on a host value
    trunner._tensors(r.init_params())


def _delivered(build, nb, mode, chunk_steps=C):
    fg, blks = build(nb)
    r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
    assert r.cfg.n_batches == nb
    if mode == "graph":
        r._run_graph(nb, chunk_steps)
    else:
        r._run_loop(nb)
    return blks["sink"].data()


@pytest.mark.parametrize("nb", [1, C, C + 1, 2 * C + 3])
@pytest.mark.parametrize("name", ["fused replay", "wbfm live", "fir staged"])
def test_graph_mode_delivers_what_the_loop_delivers(name, nb):
    """Chunks of GRAPH_CHUNK steps, the remainder stepped directly, the
    stacked outputs unstacked and trimmed: bit-equal to the loop for 1,
    C, C + 1 and 2C + 3 batches (the last batch cut by the head)."""
    got = _delivered(GRAPHS[name], nb, "graph")
    ref = _delivered(GRAPHS[name], nb, "loop")
    assert got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", [n for n in GRAPHS
                                  if n not in ("fused replay", "wbfm live",
                                               "fir staged")])
def test_every_model_graph_in_graph_mode_equals_the_loop(name):
    """The other model graphs, 2 chunks of 2 steps and a remainder."""
    got = _delivered(GRAPHS[name], 5, "graph", chunk_steps=2)
    np.testing.assert_array_equal(got, _delivered(GRAPHS[name], 5, "loop"))


def test_a_chunk_run_twice_continues_the_stream():
    """The chunk's second run equals batches C .. 2C-1 of the loop: its
    state tensors are advanced in place."""
    fg, _ = GRAPHS["live"](2 * C)
    r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
    chunk = trunner._Chunk(r.cfg.step, r.init_states(), r.init_params(), C,
                           "cpu")
    sink = r.cfg.order[-1].name
    runs = [chunk.run()[sink] for _ in range(2)]
    states, params, loop = r.init_states(), r.init_params(), []
    for _ in range(2 * C):
        states, out = r.cfg.step(states, params)
        loop.append(out[sink])
    for k in range(2):
        assert runs[k].shape[0] == C
        assert torch.equal(runs[k], torch.stack(loop[k * C:(k + 1) * C]))


def _wb_graph(center=200e3, tone=231_250.0, live=False):
    src = "live" if live else tanalog.sig_source(FS, "complex",
                                                 frequency=tone)
    fg, blks = tmodels.wbfm_receiver(center_freq=center, source=src,
                                     batch_size=WB_BATCH, sink="vector",
                                     fused=True,
                                     n_samples=5 * WB_BATCH // 20)
    if live:
        blks["source"].set_frequency(tone)
    return fg, blks


@pytest.mark.parametrize("live", [False, True])
def test_a_dphase_change_between_runs_takes_effect(live):
    """One runner run twice: a new tone (a dphase copied into its tensor in
    place, the chunk kept) gives what a fresh runner gives."""
    fg, blks = _wb_graph(live=live)
    r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
    r._run_graph(r.cfg.n_batches, 2)
    first, chunk = blks["sink"].data().copy(), r._chunk
    blks["source"].set_frequency(187_500.0)
    r._run_graph(r.cfg.n_batches, 2)
    assert r._chunk is chunk
    fg2, blks2 = _wb_graph(tone=187_500.0, live=live)
    r2 = trunner.Runner(fg2, device="cpu", batch_size=fg2.batch_size)
    r2._run_graph(r2.cfg.n_batches, 2)
    np.testing.assert_array_equal(blks["sink"].data(), blks2["sink"].data())
    assert not np.array_equal(first, blks["sink"].data())


@pytest.mark.parametrize("attached", [True, False])
def test_a_center_freq_change_rebuilds_the_chunk(attached):
    """center_freq is a fence: set while the runner is attached (a running
    graph) or between runs, the runner finds the value changed from the
    one its chunk was captured with, builds a new chunk, and the run
    equals a fresh runner's."""
    fg, blks = _wb_graph()
    r = trunner.Runner(fg, device="cpu", batch_size=fg.batch_size)
    r._run_graph(r.cfg.n_batches, 2)
    chunk = r._chunk
    for b in r.cfg.order:
        b._runtime = r if attached else None
    blks["fused"].set_param("center_freq", 210e3)
    assert (blks["fused"].name in r._dirty_params) == attached
    r._run_graph(r.cfg.n_batches, 2)
    assert r._chunk is not chunk
    assert r._chunk.fences == {(blks["fused"].name, "center_freq"): 210e3}
    fg2, blks2 = _wb_graph(center=210e3)
    trunner.Runner(fg2, device="cpu", batch_size=fg2.batch_size)._run_graph(5, 2)
    np.testing.assert_array_equal(blks["sink"].data(), blks2["sink"].data())


# -- the port's bench --------------------------------------------------------

def test_bench_gates_hold_on_a_small_cpu_batch(capsys):
    """python3 -m newsched_tpu_torch.bench --device cpu: every path passes
    its SNR gate at the small batch, and the last line carries every key of
    the reference's bench.py, each a positive rate."""
    from newsched_tpu_torch import bench

    assert bench.main(["--device", "cpu", "--k1", "1", "--k2", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "fm_channelizer_64ch_flowgraph_throughput"
    assert out["device"] == "cpu" and out["unit"] == "Msamples/s/gpu"
    for key in ("value", "vs_baseline", "live_value", "wbfm_staged_value",
                "wbfm_fused_value", "wbfm_live_value", "fir_staged_value",
                "fir_live_value"):
        assert out[key] > 0, key


def test_bench_module_imports_no_jax():
    """The port's bench imports neither jax, the JAX package, nor the root
    bench.py (or bench/)."""
    code = ("import sys, newsched_tpu_torch.bench\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'newsched_tpu', 'bench'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
