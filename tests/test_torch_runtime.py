"""The port's runtime core held against the reference: the compiler's rate
algebra on the fused slice's graphs and on graph shapes from
tests/test_runtime_graph.py, and the general blocks end to end on the CPU.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import newsched_tpu.blocks.general as jgen
import newsched_tpu.runtime.block as jblock
from newsched_tpu import models as jmodels
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

import newsched_tpu_torch.blocks.general as tgen
import newsched_tpu_torch.runtime.block as tblock
from newsched_tpu_torch import models as tmodels
from newsched_tpu_torch.runtime.compile import compile_flowgraph as tcompile
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

PKGS = {"jax": (jgen, jblock, JFlowgraph, jcompile),
        "torch": (tgen, tblock, TFlowgraph, tcompile)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would starve the timing-
    sensitive multiprocess tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rate_cls(block_mod):
    class Rate(block_mod.Block):
        """Stand-in block: a declared rate, input count, per-port ratios,
        input multiple or lead; never executed."""

        def __init__(self, rate=1, n_in=1, dtype="cf32", ratios=None,
                     multiple=1, lead=None, name=None):
            super().__init__(name)
            self.relative_rate = Fraction(rate)
            for i in range(n_in):
                self.add_input(f"in{i}", dtype)
            self.add_output("out", dtype)
            if ratios:
                self.in_port_ratios = ratios
            if multiple > 1:
                self.in_multiple = multiple
            if lead is not None:
                self.lead_items = lambda in_lead, nin, nout: in_lead + lead

        def work(self, state, ins, params, nout):
            raise AssertionError("rate-algebra stand-in")

    return Rate


def _g_roundtrip(gen, Rate, Fg):
    fg = Fg(batch_size=256)
    src = gen.vector_source(np.zeros(1000, np.complex64), name="src")
    snk = gen.vector_sink(name="snk")
    fg.connect(src, 0, snk, 0)
    return fg


def _g_head_chain(gen, Rate, Fg):
    fg = Fg(batch_size=64)
    src = gen.vector_source(np.zeros(7, np.float32), repeat=True, name="src")
    hd = gen.head(200, dtype="rf32", name="hd")
    snk = gen.vector_sink(dtype="rf32", name="snk")
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg


def _g_decimators(gen, Rate, Fg):
    fg = Fg(batch_size=1000)
    src = gen.vector_source(np.zeros(10_000, np.complex64), name="src")
    d1 = Rate(Fraction(1, 4), name="d1")
    i1 = Rate(3, name="i1")
    d2 = Rate(Fraction(2, 5), name="d2")
    snk = gen.vector_sink(name="snk")
    fg.connect(src, 0, d1, 0)
    fg.connect(d1, 0, i1, 0)
    fg.connect(i1, 0, d2, 0)
    fg.connect(d2, 0, snk, 0)
    return fg


def _g_multi_input_fanout(gen, Rate, Fg):
    fg = Fg(batch_size=100)
    a = gen.vector_source(np.zeros(333, np.complex64), name="a")
    b = gen.vector_source(np.zeros(500, np.complex64), name="b")
    add = Rate(1, n_in=2, name="add")
    s1, s2 = gen.vector_sink(name="s1"), gen.null_sink(name="s2")
    fg.connect(a, 0, add, 0)
    fg.connect(b, 0, add, 1)
    fg.connect(add, 0, s1, 0)
    fg.connect(add, 0, s2, 0)
    return fg


def _g_port_ratios(gen, Rate, Fg):
    fg = Fg(batch_size=128)
    sd = gen.vector_source(np.zeros(1024, np.float32), name="sd")
    sc = gen.vector_source(np.zeros(256, np.float32), name="sc")
    dec = Rate(Fraction(1, 4), dtype="rf32", name="dec")
    blk = Rate(1, n_in=2, dtype="rf32", ratios={"in1": Fraction(1, 4)},
               name="blk")
    snk = gen.vector_sink(dtype="rf32", name="snk")
    fg.connect(sd, 0, blk, 0)
    fg.connect(sc, 0, dec, 0)
    fg.connect(dec, 0, blk, 1)
    fg.connect(blk, 0, snk, 0)
    return fg


def _g_lead_and_multiple(gen, Rate, Fg):
    fg = Fg(batch_size=100)
    src = gen.vector_source(np.zeros(1000, np.float32), name="src")
    skip = Rate(1, dtype="rf32", lead=35, name="skip")
    keep = Rate(Fraction(3, 7), dtype="rf32", multiple=7, name="keep")
    snk = gen.vector_sink(dtype="rf32", name="snk")
    fg.connect(src, 0, skip, 0)
    fg.connect(skip, 0, keep, 0)
    fg.connect(keep, 0, snk, 0)
    return fg


GRAPHS = [_g_roundtrip, _g_head_chain, _g_decimators, _g_multi_input_fanout,
          _g_port_ratios, _g_lead_and_multiple]


def _algebra(cfg):
    return (cfg.batch_ref, cfg.n_in, cfg.n_out, cfg.bounds, cfg.leads,
            cfg.n_batches, cfg.sink_totals, cfg.sink_leads,
            [b.name for b in cfg.order])


@pytest.mark.parametrize("build", GRAPHS, ids=lambda f: f.__name__[3:])
def test_rate_algebra_matches_reference(build):
    got = {}
    for pkg, (gen, block_mod, Fg, compile_fn) in PKGS.items():
        fg = build(gen, _rate_cls(block_mod), Fg)
        got[pkg] = _algebra(compile_fn(fg, batch_size=fg.batch_size))
    assert got["torch"] == got["jax"]


def _positional(cfg):
    """The algebra by topological position (models name blocks with
    per-package counters)."""
    pos = [b.name for b in cfg.order]
    idx = {n: i for i, n in enumerate(pos)}

    def re(d):
        return {idx[k]: v for k, v in d.items()}

    return (cfg.batch_ref, re(cfg.n_in), re(cfg.n_out), re(cfg.bounds),
            re(cfg.leads), cfg.n_batches, re(cfg.sink_totals),
            re(cfg.sink_leads), [type(b).__name__ for b in cfg.order])


@pytest.mark.parametrize("source", ["planes", "cf32"])
@pytest.mark.parametrize("sink,n_batches", [("vector", 3), ("null", 2)])
def test_rate_algebra_of_the_fused_slice(source, sink, n_batches):
    M, decim, rows = 16, 4, 256
    got = {}
    for pkg, (gen, _, _, compile_fn) in PKGS.items():
        models = jmodels if pkg == "jax" else tmodels
        if source == "planes":
            src = gen.vector_source(np.zeros((rows * 3, 2 * M), np.float32),
                                    repeat=True)
        else:
            src = gen.vector_source(np.zeros(rows * M * 3, np.complex64))
        fg, _ = models.fm_channelizer(
            nchans=M, taps_per_arm=8, audio_decim=decim, fused=True,
            source=src, batch_size=rows * M, sink=sink,
            n_samples=n_batches * rows // decim,
            audio_taps=np.ones(17, np.float32))
        got[pkg] = _positional(compile_fn(fg, batch_size=fg.batch_size))
    assert got["torch"] == got["jax"]
    assert got["torch"][5] == n_batches


def test_general_blocks_end_to_end_match_reference():
    """vector_source -> head -> vector_sink and a null_sink checksum, run by
    both runners on the same data (non-divisible totals, padded last
    batch)."""
    rng = np.random.default_rng(4)
    data = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
            ).astype(np.complex64)
    out = {}
    for pkg, (gen, _, Fg, _) in PKGS.items():
        fg = Fg(batch_size=128)
        src = gen.vector_source(data)
        hd = gen.head(900)
        snk = gen.vector_sink()
        nul = gen.null_sink()
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        fg.connect(src, 0, nul, 0)
        if pkg == "jax":
            fg.run()
        else:
            fg.run(device="cpu")
        out[pkg] = (snk.data(), nul.checksum)
    np.testing.assert_array_equal(out["torch"][0], data[:900])
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-5)


def test_vector_source_repeat_wraps_like_reference():
    data = np.arange(10, dtype=np.float32)
    out = {}
    for pkg, (gen, _, Fg, _) in PKGS.items():
        fg = Fg(batch_size=4)
        src = gen.vector_source(data, repeat=True)
        hd = gen.head(23, dtype="rf32")
        snk = gen.vector_sink(dtype="rf32")
        fg.connect(src, 0, hd, 0)
        fg.connect(hd, 0, snk, 0)
        fg.run() if pkg == "jax" else fg.run(device="cpu")
        out[pkg] = snk.data()
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"], np.tile(data, 3)[:23])


def test_params_are_tensors_on_the_run_device_and_rebind():
    """param_leaves builds tensors on the given device; set_param while a
    runner is attached marks the block for a rebuild at the next batch."""
    blk = tgen.head(4)
    blk.declare_param("gain", 2.0)
    leaves = blk.param_leaves("cpu")
    assert isinstance(leaves["gain"], torch.Tensor)
    assert leaves["gain"].dtype == torch.float32 and float(leaves["gain"]) == 2.0

    class Rt:
        dirty = []

        def invalidate_params(self, b):
            self.dirty.append(b.name)

    blk._runtime = Rt()
    blk.set_param("gain", 3.0)
    assert Rt.dirty == [blk.name]
    assert float(blk.param_leaves("cpu")["gain"]) == 3.0


def test_unbounded_graph_is_refused():
    fg = TFlowgraph(batch_size=16)
    fg.connect(tgen.vector_source(np.zeros(4, np.float32), repeat=True), 0,
               tgen.null_sink(dtype="rf32"), 0)
    with pytest.raises(ValueError, match="unbounded"):
        fg.run(device="cpu")


def test_hier_block_flattens_and_total_items_bounds_a_stream():
    """A HierBlock's inner graph is absorbed at connect time, and
    total_items bounds an otherwise unbounded repeating source."""
    from newsched_tpu_torch.runtime.graph import HierBlock

    class passthrough(HierBlock):
        def __init__(self):
            super().__init__()
            a, b = tgen.head(10**9, dtype="rf32"), tgen.head(10**9, dtype="rf32")
            self.graph.connect(a, 0, b, 0)
            self.map_input("in", a.i())
            self.map_output("out", b.o())

    data = np.arange(6, dtype=np.float32)
    fg = TFlowgraph(batch_size=4)
    hier, snk = passthrough(), tgen.vector_sink(dtype="rf32")
    fg.connect(tgen.vector_source(data, repeat=True), 0, hier, 0)
    fg.connect(hier, 0, snk, 0)
    assert len(fg.blocks) == 4 and hier not in fg.blocks
    fg.run(device="cpu", total_items=15)
    np.testing.assert_array_equal(snk.data(), np.tile(data, 3)[:15])
