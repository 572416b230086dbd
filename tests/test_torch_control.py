"""The port's runtime control plane held against the JAX package on the CPU
(the counterparts of tests/test_aux.py's runtime tests and of
tests/test_runtime_graph.py's copy chain and fanout): checkpoints and
resume, stats, parameter changes between batches, message ports, the
profiler trace, unbounded runs under start()/stop() as chunk replays or as
the loop, throttle pacing, the unbounded-collector refusal and the ring
soaks, and a fence set from another thread during an unbounded run.

Every run that starts a thread stops it and joins it with a timeout of
JOIN_S seconds, then asserts that it ended: a hang fails the test.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from newsched_tpu import Flowgraph as JFlowgraph
from newsched_tpu.blocks import analog as janalog, general as jgen, \
    math as jmath, streamops as jstreamops
from newsched_tpu.runtime.runner import Runner as JRunner

from newsched_tpu_torch import models as tmodels
from newsched_tpu_torch.blocks import analog as tanalog, general as tgen
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fm_chain
from newsched_tpu_torch.runtime import block as tblock, runner as trunner
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

JOIN_S = 10.0  # the longest a test waits for a runner thread to end
TOL = 2e-5  # port vs reference tone: polynomial vs libm sin/cos, FP32
C = trunner.GRAPH_CHUNK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2)).astype(np.complex64)


def _stop_and_join(fg, runner) -> None:
    """stop(), then join the runner's thread within JOIN_S; wait() raises
    what failed on it."""
    fg.stop()
    thread = runner._thread
    thread.join(JOIN_S)
    assert not thread.is_alive(), "the runner thread did not end"
    fg.wait()


def _until(cond, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < JOIN_S, f"timed out waiting for {what}"
        time.sleep(0.005)


# -- test-local blocks for the reference's math/streamops ones --------------

class _scale(tblock.SyncBlock):
    """out = k * in with a settable complex k (the reference's
    math.multiply_const)."""

    def __init__(self, k=1.0 + 0j, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        self.declare_param("k", k, dtype=np.complex64)

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"] * params["k"]}


class _add_const(tblock.SyncBlock):
    """rf32 out = in + c (the reference's math.add_const)."""

    def __init__(self, c: float, name=None):
        super().__init__(name)
        self.c = float(c)
        self.add_input("in", "rf32")
        self.add_output("out", "rf32")

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"] + self.c}


class _keep_one_in_n(tblock.Block):
    """rf32, every n-th item (the reference's streamops.keep_one_in_n)."""

    def __init__(self, n: int, name=None):
        super().__init__(name)
        from fractions import Fraction

        self.n = int(n)
        self.relative_rate = Fraction(1, self.n)
        self.in_multiple = self.n
        self.add_input("in", "rf32")
        self.add_output("out", "rf32")

    def work(self, state, ins, params, nout):
        return state, {"out": ins["in"][::self.n]}


# -- checkpoints ------------------------------------------------------------

def _tone(pkg, n=2048):
    Fg, gen, an = ((JFlowgraph, jgen, janalog) if pkg == "jax"
                   else (TFlowgraph, tgen, tanalog))
    fg = Fg(batch_size=256)
    src = an.sig_source(1e6, "complex", frequency=12345.0)
    hd, snk = gen.head(n), gen.vector_sink()
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, snk


def _live_channelizer(nb):
    at = firdes.low_pass(1.0, 1.0, 0.05, 0.0125, ntaps=65)
    fg, blks = tmodels.fm_channelizer(nchans=64, taps_per_arm=16,
                                      audio_decim=8, fused=True, source="live",
                                      batch_size=256 * 64, sink="vector",
                                      n_samples=nb * 32, audio_taps=at)
    return fg, blks["sink"]


def _wbfm_live(nb):
    fg, blks = tmodels.wbfm_receiver(source="live", batch_size=38400,
                                     sink="vector", fused=True,
                                     n_samples=nb * 38400 // 20)
    blks["source"].set_frequency(231_250.0)
    return fg, blks["sink"]


def test_checkpoint_resume_matches_continuous_and_the_reference(tmp_path):
    """8 batches straight through; 4, a checkpoint, a resume for 4 more:
    the same stream bit for bit; within TOL of the reference's run (which
    does the same with Orbax)."""
    fg, snk = _tone("torch")
    fg.run(device="cpu", collect_stats=True)
    full = snk.data()
    fg1, snk1 = _tone("torch")
    fg1.run(device="cpu", total_items=1024, checkpoint_path=str(tmp_path),
            checkpoint_every=4)
    fg2, snk2 = _tone("torch")
    fg2.run(device="cpu", resume_from=str(tmp_path))
    got = np.concatenate([snk1.data(), snk2.data()[:2048 - 1024]])
    np.testing.assert_array_equal(got, full)
    assert os.listdir(tmp_path) == ["step_4"]
    jfg, jsnk = _tone("jax")
    jfg.run()
    np.testing.assert_allclose(full, jsnk.data(), rtol=0, atol=TOL)


@pytest.mark.parametrize("build", [_live_channelizer, _wbfm_live],
                         ids=["live channelizer (K5)", "live receiver (K12)"])
def test_checkpoint_of_a_live_source_resumes_its_stream(tmp_path, build):
    """The live sources' state (the int64 noise counter, the NCO phase, the
    first-batch flag, the chain's carries) goes into the checkpoint: 2N
    batches straight equal N, a checkpoint and N resumed, bit for bit."""
    n = 3
    fg, snk = build(2 * n)
    fg.run(device="cpu")
    fg1, snk1 = build(n)
    fg1.run(device="cpu", checkpoint_path=str(tmp_path), checkpoint_every=n)
    fg2, snk2 = build(2 * n)
    r = fg2.run(device="cpu", resume_from=str(tmp_path))
    assert r.stats["batches"] == n
    np.testing.assert_array_equal(np.concatenate([snk1.data(), snk2.data()]),
                                  snk.data())
    saved = torch.load(tmp_path / f"step_{n}" / "state.pt", weights_only=True)
    dtypes = {t.dtype for ts in saved["states"].values() for t in ts}
    assert torch.int64 in dtypes  # the noise counter, or the NCO phase


def test_resume_refuses_another_graph(tmp_path):
    fg, _ = _tone("torch")
    fg.run(device="cpu", checkpoint_path=str(tmp_path))
    fg2, _ = _live_channelizer(2)
    with pytest.raises(ValueError, match="does not match"):
        fg2.run(device="cpu", resume_from=str(tmp_path))


# -- stats, parameters, messages, the profiler -------------------------------

def test_runner_stats():
    data = _rand_complex(1024)
    out = {}
    for pkg, (Fg, gen) in {"jax": (JFlowgraph, jgen),
                           "torch": (TFlowgraph, tgen)}.items():
        fg = Fg(batch_size=128)
        snk = gen.null_sink()
        fg.connect(gen.vector_source(data), 0, snk, 0)
        runner = fg.run(collect_stats=True) if pkg == "jax" else \
            fg.run(device="cpu", collect_stats=True)
        assert runner.stats["batches"] == 8
        assert runner.stats["items"] == 1024
        assert len(runner.stats["batch_seconds"]) == 8
        out[pkg] = snk.checksum
    assert out["torch"] == pytest.approx(out["jax"], rel=1e-5)


def _param_change_graph(pkg):
    data = np.ones(1024, np.complex64)
    Fg, gen = (JFlowgraph, jgen) if pkg == "jax" else (TFlowgraph, tgen)
    fg = Fg(batch_size=256)
    mc = jmath.multiply_const(1.0 + 0j, dtype="cf32") if pkg == "jax" \
        else _scale()
    snk = gen.vector_sink()
    fg.connect(gen.vector_source(data), 0, mc, 0)
    fg.connect(mc, 0, snk, 0)
    fg.validate()
    runner = (JRunner(fg, batch_size=256, collect_stats=True) if pkg == "jax"
              else trunner.Runner(fg, device="cpu", batch_size=256,
                                  collect_stats=True))
    orig, counter = runner._drain_msgs, {"i": 0}

    def drain():  # a parameter change after batch 2, from the batch loop
        if counter["i"] == 2:
            mc.set_param("k", 5.0 + 0j)
        counter["i"] += 1
        orig()

    runner._drain_msgs = drain
    runner.run_to_completion()
    return snk.data()


def test_live_param_change_between_batches():
    """A parameter set between batches takes effect at the next one, in
    both packages alike."""
    out = _param_change_graph("torch")
    np.testing.assert_allclose(out[:512], 1.0)
    np.testing.assert_allclose(out[512:], 5.0)
    np.testing.assert_array_equal(out, _param_change_graph("jax"))


def test_msg_forward_chain():
    """Message ports: post -> forward -> forward, drained between batches."""
    got = {}
    for pkg, (Fg, gen, R) in {"jax": (JFlowgraph, jgen, JRunner),
                              "torch": (TFlowgraph, tgen,
                                        trunner.Runner)}.items():
        fg = Fg(batch_size=128)
        fg.connect(gen.vector_source(_rand_complex(512)), 0, gen.null_sink(), 0)
        m1, m2 = gen.msg_forward(), gen.msg_forward()
        fg.msg_connect(m1, "out", m2, "in")
        fg.validate()
        kw = {} if pkg == "jax" else {"device": "cpu"}
        runner = R(fg, batch_size=128, collect_stats=True, **kw)
        for b in (m1, m2):
            b._runtime = runner
        m1._msg_handlers["in"]({"hello": 1})
        assert m2.received == []  # queued for the run's first batch
        runner.run_to_completion()
        got[pkg] = (m1.received, m2.received)
    assert got["torch"] == got["jax"] == ([{"hello": 1}], [{"hello": 1}])


def test_msg_connect_needs_a_handler():
    fg = TFlowgraph()
    with pytest.raises(KeyError, match="no message input"):
        fg.msg_connect(tgen.msg_forward(), "out", tgen.msg_forward(), "nope")


def test_profiler_trace_writes_output(tmp_path):
    """Runner(profile_dir=...) writes a torch.profiler trace of the run."""
    fg = TFlowgraph(batch_size=256)
    hd = tgen.head(1024, dtype="rf32")
    snk = tgen.null_sink(dtype="rf32")
    fg.connect(tgen.null_source(dtype="rf32"), 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    fg.validate()
    trunner.Runner(fg, device="cpu", batch_size=256,
                   profile_dir=str(tmp_path / "trace")).run_to_completion()
    hits = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert hits and os.path.getsize(tmp_path / "trace" / hits[0]) > 0
    assert snk.checksum == 0.0


# -- unbounded runs ------------------------------------------------------------

def test_unbounded_chunked():
    """start() on an unbounded graph runs as chunks (on the CPU the chunk's
    steps called) until stop(), and delivers what streamed: every item is
    0 + 1, so the checksum is the item count."""
    fg = TFlowgraph(batch_size=4096)
    mc, snk = _add_const(1.0), tgen.null_sink(dtype="rf32")
    fg.connect(tgen.null_source(dtype="rf32"), 0, mc, 0)
    fg.connect(mc, 0, snk, 0)
    runner = fg.start(device="cpu")
    _until(lambda: runner.stats["batches"] >= 2 * C, "two chunks")
    _stop_and_join(fg, runner)
    assert runner.stats["batches"] >= 2 * C and runner.stats["batches"] % C == 0
    assert runner._chunk is not None
    assert snk.checksum == pytest.approx(runner.stats["items"])


def test_run_refuses_an_unbounded_graph_that_start_runs():
    fg = TFlowgraph(batch_size=64)
    snk = tgen.null_sink(dtype="rf32")
    fg.connect(tgen.null_source(dtype="rf32"), 0, snk, 0)
    with pytest.raises(ValueError, match="start\\(\\)/stop\\(\\)"):
        fg.run(device="cpu")


def test_throttle_paces_in_its_own_rate_domain():
    """A throttle after a decimator paces by its own (decimated) stream
    rate, not the source rate: 256 items at 2000/s take 0.128 s (source-rate
    pacing would take 0.512 s)."""
    dts = {}
    for pkg in ("jax", "torch"):
        Fg, gen = (JFlowgraph, jgen) if pkg == "jax" else (TFlowgraph, tgen)
        fg = Fg(batch_size=256)
        dec = jstreamops.keep_one_in_n(4, dtype="rf32") if pkg == "jax" \
            else _keep_one_in_n(4)
        thr = gen.throttle(2000.0, dtype="rf32")
        hd, snk = gen.head(256, dtype="rf32"), gen.null_sink(dtype="rf32")
        fg.connect(gen.null_source(dtype="rf32"), 0, dec, 0)
        fg.connect(dec, 0, thr, 0)
        fg.connect(thr, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        t0 = time.monotonic()
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        dts[pkg] = time.monotonic() - t0
    assert 0.12 <= dts["torch"] < 0.4, f"paced in {dts['torch']:.3f} s"


def test_unbounded_collector_without_capacity_rejected():
    """A capacity-less vector_sink on an unbounded stream is refused when
    the run starts; wait() raises it."""
    fg = TFlowgraph(batch_size=1024)
    fg.connect(tgen.null_source(dtype="rf32"), 0, tgen.vector_sink(dtype="rf32"),
               0)
    runner = fg.start(device="cpu")
    runner._thread.join(JOIN_S)
    assert not runner._thread.is_alive()
    with pytest.raises(RuntimeError, match="UNBOUNDED"):
        fg.wait()


def _ramp_soak(throttled: bool, cap: int, batch: int):
    N = 3000  # the ramp's period, not a batch multiple
    fg = TFlowgraph(batch_size=batch)
    src = tgen.vector_source(np.arange(N, dtype=np.float32), repeat=True)
    snk = tgen.vector_sink(dtype="rf32", capacity=cap)
    if throttled:  # the loop, with no real pacing
        thr = tgen.throttle(1e12, dtype="rf32")
        fg.connect(src, 0, thr, 0)
        fg.connect(thr, 0, snk, 0)
    else:
        fg.connect(src, 0, snk, 0)
    runner = fg.start(device="cpu")
    _until(lambda: runner.stats["batches"] >= 3 * C, "three chunks' batches")
    _stop_and_join(fg, runner)
    return runner, snk.data(), N


def test_unbounded_ring_capacity_soak_chunked():
    """vector_sink(capacity=K) on an unbounded graph run as chunks keeps a
    bounded trailing window: at most K + one chunk of batches held, and
    data() exactly the stream's last K items."""
    cap, batch = 512, 256
    runner, got, N = _ramp_soak(False, cap, batch)
    items = runner.stats["items"]
    assert items >= 3 * C * batch
    assert runner.stats["retained_items"] <= cap + C * batch
    assert len(got) == cap
    np.testing.assert_array_equal(
        got, (np.arange(items - cap, items) % N).astype(np.float32))


def test_unbounded_ring_capacity_soak_loop_mode():
    """The same bound through the loop (a throttle rules graph mode out):
    the ring trims per batch, and the window is the stream's last items."""
    cap, batch = 300, 128
    runner, got, N = _ramp_soak(True, cap, batch)
    items = runner.stats["items"]
    assert runner.stats["retained_items"] <= cap + 2 * batch
    assert len(got) == cap
    np.testing.assert_array_equal(
        got, (np.arange(items - cap, items) % N).astype(np.float32))


def test_set_param_from_another_thread_lands_between_batches():
    """Writers on other threads set a scale block's k while an unbounded
    graph runs (switch interval shortened): every batch is scaled by one
    of the values set, whole, none lost or torn, and the last value set
    reaches the stream."""
    import sys

    fg = TFlowgraph(batch_size=512)
    src = tgen.vector_source(np.ones(512, np.complex64), repeat=True)
    mc, snk = _scale(), tgen.vector_sink(capacity=512 * 64)
    fg.connect(src, 0, mc, 0)
    fg.connect(mc, 0, snk, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runner = fg.start(device="cpu")

        def writer(w):
            for i in range(50):
                mc.set_param("k", complex(1 + w * 100 + i))

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
        mc.set_param("k", 7.0 + 0j)
        b0 = runner.stats["batches"]
        _until(lambda: runner.stats["batches"] >= b0 + 2 * C, "two chunks")
        _stop_and_join(fg, runner)
    finally:
        sys.setswitchinterval(interval)
    per_batch = snk.data().reshape(-1, 512)
    assert np.all(per_batch == per_batch[:, :1])  # whole batches
    allowed = {1.0, 7.0} | {1.0 + w * 100 + i for w in range(8)
                            for i in range(50)}
    assert set(per_batch[:, 0].real.tolist()) <= allowed
    assert per_batch[-1, 0] == 7.0


class _gate(tblock.SyncBlock):
    """A cf32 pass-through that, at its ``pause_at``-th step, says so
    (``inside``) and waits for ``go``: a run held in the middle of a chunk."""

    def __init__(self, pause_at: int, name=None):
        super().__init__(name)
        self.add_input("in", "cf32")
        self.add_output("out", "cf32")
        self.pause_at, self.calls = pause_at, 0
        self.inside, self.go = threading.Event(), threading.Event()

    def work(self, state, ins, params, nout):
        self.calls += 1
        if self.calls == self.pause_at:
            self.inside.set()
            assert self.go.wait(JOIN_S)
        return state, {"out": ins["in"]}


def test_a_fence_set_from_another_thread_lands_at_a_chunk_boundary():
    """center_freq (a fence: its hook rebuilds the fused receiver's rotated
    taps) set from another thread while an unbounded run is held in the
    middle of its second chunk: the change waits for the chunk and lands
    at a chunk boundary. Every batch before it equals a run at the old
    value, every batch from it on a fresh run at the new value."""
    nb_batch, old, new = 38400, 200e3, 210e3

    def build(center, n_samples, gate=None):
        sig = tanalog.sig_source(1e6, "complex", frequency=231_250.0)
        fg, blks = tmodels.wbfm_receiver(
            center_freq=center, source=gate or sig, batch_size=nb_batch,
            sink="vector", fused=True, n_samples=n_samples)
        if gate is not None:
            fg.connect(sig, 0, gate, 0)
        return fg, blks

    gate = _gate(pause_at=C + C // 2)
    fg, blks = build(old, None, gate)
    blks["sink"].collect_capacity = 64 * nb_batch // 20
    runner = fg.start(device="cpu")
    assert gate.inside.wait(JOIN_S)
    setter = threading.Thread(
        target=blks["fused"].set_param, args=("center_freq", new))
    setter.start()
    time.sleep(0.2)  # time enough for the setter to land mid-chunk, if it could
    gate.go.set()
    setter.join(JOIN_S)
    assert not setter.is_alive()
    _until(lambda: runner.stats["batches"] >= 4 * C, "four chunks")
    _stop_and_join(fg, runner)
    n = runner.stats["batches"]
    assert n <= 64, "the ring dropped batches: the run went on too long"
    got = blks["sink"].data().reshape(n, -1)
    refs = {}
    for center in (old, new):
        rfg, rblks = build(center, n * nb_batch // 20)
        rfg.run(device="cpu")
        refs[center] = rblks["sink"].data().reshape(n, -1)
    at_old = [np.array_equal(got[i], refs[old][i]) for i in range(n)]
    k = at_old.index(False)
    assert k % C == 0 and 2 * C <= k < n, f"the fence landed at batch {k}"
    assert all(at_old[:k])
    np.testing.assert_array_equal(got[k:], refs[new][k:])


def test_a_finished_runner_leaves_no_cyclic_garbage():
    """A runner, its chunk and what the chunk keeps alive are freed by
    reference counting once the run ends: nothing waits for the cycle
    collector, which would free an old CUDA graph whenever it next runs,
    in the middle of another capture too."""
    import gc
    import weakref

    fg = TFlowgraph(batch_size=16)
    fg.connect(tgen.vector_source(np.ones(64, np.float32)), 0,
               tgen.vector_sink(dtype="rf32"), 0)
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        r = trunner.Runner(fg, device="cpu", batch_size=16)
        for b in r.cfg.order:  # attached, as while running
            b._runtime = r
        r._run_graph(r.cfg.n_batches, 2)
        for b in r.cfg.order:
            b._runtime = None
        assert r._chunk is not None and r._chunk.keep
        gone = weakref.ref(r)
        del r
        assert gone() is None
    finally:
        if gc_was_on:
            gc.enable()


# -- the runtime graph tests: copy chain and fanout ---------------------------

def test_copy_chain_and_fanout_match_reference():
    data = _rand_complex(512)
    out = {}
    for pkg, (Fg, gen) in {"jax": (JFlowgraph, jgen),
                           "torch": (TFlowgraph, tgen)}.items():
        fg = Fg(batch_size=128)
        src = gen.vector_source(data)
        c1, c2, nop = gen.copy(), gen.copy(), gen.nop()
        fan = gen.fanout(2)
        s1, s2, s3 = gen.vector_sink(), gen.vector_sink(), gen.vector_sink()
        fg.connect(src, 0, c1, 0)
        fg.connect(c1, 0, c2, 0)
        fg.connect(c2, 0, s1, 0)
        fg.connect(c1, 0, nop, 0)
        fg.connect(nop, 0, fan, 0)
        fg.connect(fan, "out0", s2, 0)
        fg.connect(fan, "out1", s3, 0)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        out[pkg] = [s.data() for s in (s1, s2, s3)]
    for t, j in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(t, data)
        np.testing.assert_array_equal(t, j)


def test_load_and_null_sources_match_reference():
    """load's multiply-adds and nop_source/null_source zeros into
    nop_sink/null_sink checksums, as the reference computes them."""
    data = _rand_complex(1024, 3)
    out = {}
    for pkg, (Fg, gen) in {"jax": (JFlowgraph, jgen),
                           "torch": (TFlowgraph, tgen)}.items():
        fg = Fg(batch_size=256)
        ld, snk = gen.load(3), gen.vector_sink()
        fg.connect(gen.vector_source(data), 0, ld, 0)
        fg.connect(ld, 0, snk, 0)
        hd, ns = gen.head(512), gen.nop_sink()
        fg.connect(gen.nop_source(), 0, hd, 0)
        fg.connect(hd, 0, ns, 0)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        out[pkg] = (snk.data(), ns.checksum)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=1e-6)
    assert out["torch"][1] == out["jax"][1] == 0.0
    assert fm_chain.fm_chain_step_planes.launches == 0
