"""Stream tags in the port (runtime/tags.py and the compiler's tag plane),
held against the JAX package's tests/test_tags.py: each graph runs in both
packages on the same numpy inputs and the sinks' tags (offsets, keys,
values, payloads) must be equal; where the data is checked, it is held to
the reference's output or to scipy. Both packages run the same blocks:
math.add for the merges, fft_filter for config #3's long filter.
"""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from newsched_tpu import Flowgraph as JFlowgraph, models as jmodels
from newsched_tpu.blocks import filter as jfilt, general as jgen, math as jmath
from newsched_tpu.ops import firdes
from newsched_tpu.runtime import block as jblock

from newsched_tpu_torch import models as tmodels
from newsched_tpu_torch.blocks import filter as tfilt, general as tgen, \
    math as tmath
from newsched_tpu_torch.parallel import make_mesh
from newsched_tpu_torch.runtime import block as tblock, tags as ttags
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
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2)).astype(np.complex64)


PKGS = {"jax": (JFlowgraph, jgen, lambda: jmath.add(2), jblock),
        "torch": (TFlowgraph, tgen, lambda: tmath.add(2), tblock)}


def _run(pkg, fg, **kw):
    return fg.run(**kw) if pkg == "jax" else fg.run(device="cpu", **kw)


def _both(build, **kw):
    """build(pkg) -> (fg, {name: sink}); the sinks' tags and data and the
    runners of both packages."""
    out = {}
    for pkg in PKGS:
        fg, sinks = build(pkg)
        runner = _run(pkg, fg, **kw)
        out[pkg] = ({k: s.tags() for k, s in sinks.items()},
                    {k: s.data() for k, s in sinks.items()}, runner)
    return out["jax"], out["torch"]


def _same_tags(jt: list, tt: list) -> None:
    assert [tuple(t) for t in tt] == [tuple(t) for t in jt]
    assert all(isinstance(t, ttags.Tag) for t in tt)


def _chain(tag_list, n, batch, mid=None, seed=0):
    """vector_source(tags) -> [mid] -> vector_sink in either package."""
    data = _rand_complex(n, seed)

    def build(pkg):
        Fg, gen, _, _ = PKGS[pkg]
        fg = Fg(batch_size=batch)
        src = gen.vector_source(data, tags=tag_list)
        snk = gen.vector_sink()
        blk = mid(pkg) if mid is not None else gen.copy()
        fg.connect(src, 0, blk, 0)
        fg.connect(blk, 0, snk, 0)
        return fg, {"snk": snk}

    return build, data


def test_tags_passthrough_sync_chain():
    build, data = _chain([(0, "start", 1.0), (100, "a", 2.5),
                          (999, "end", 3.0)], 1024, 256)
    (jt, jd, _), (tt, td, _) = _both(build)
    _same_tags(jt["snk"], tt["snk"])
    assert [(t.offset, t.key, t.value[0]) for t in tt["snk"]] == \
        [(0, "start", 1.0), (100, "a", 2.5), (999, "end", 3.0)]
    np.testing.assert_array_equal(td["snk"], data)


def test_tags_remap_through_decimator():
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    mid = {"jax": lambda: jfilt.fir_filter(taps, decim=4),
           "torch": lambda: tfilt.fir_filter(taps, decim=4)}
    build, _ = _chain([(0, "t0"), (400, "t1"), (401, "t2"), (4000, "t3")],
                      4096, 1024, mid=lambda pkg: mid[pkg]())
    (jt, jd, _), (tt, td, _) = _both(build)
    _same_tags(jt["snk"], tt["snk"])
    assert [(t.offset, t.key) for t in tt["snk"]] == \
        [(0, "t0"), (100, "t1"), (100, "t2"), (1000, "t3")]
    np.testing.assert_allclose(td["snk"], jd["snk"], rtol=1e-4, atol=1e-5)


def test_tags_through_a_long_fir_with_data_check():
    """Config #3's shape (the reference's fft_filter test): the fft_filter
    block in both packages, its tags intact and its data > 90 dB against
    scipy."""
    taps = firdes.low_pass(1.0, 1.0, 0.2, 0.02)
    mid = {"jax": lambda: jfilt.fft_filter(taps),
           "torch": lambda: tfilt.fft_filter(taps)}
    build, data = _chain([(10, "sync", 7.0), (5000, "pkt", 1.0, 2.0)], 8192,
                         2048, mid=lambda pkg: mid[pkg](), seed=33)
    (jt, jd, _), (tt, td, _) = _both(build)
    _same_tags(jt["snk"], tt["snk"])
    assert [(t.offset, t.key, t.value) for t in tt["snk"]] == \
        [(10, "sync", (7.0, 0.0)), (5000, "pkt", (1.0, 2.0))]
    ref = sig.lfilter(taps.astype(np.float64), [1.0], data.astype(np.complex128))
    assert snr_db(ref, td["snk"]) > 90 and snr_db(ref, jd["snk"]) > 90


def _two_sources(a_tags, b_tags, n, batch, seeds=(1, 2)):
    a, b = _rand_complex(n, seeds[0]), _rand_complex(n, seeds[1])

    def build(pkg):
        Fg, gen, add, _ = PKGS[pkg]
        fg = Fg(batch_size=batch)
        sa = gen.vector_source(a, tags=a_tags)
        sb = gen.vector_source(b, tags=b_tags)
        adder, snk = add(), gen.vector_sink()
        fg.connect(sa, 0, adder, 0)
        fg.connect(sb, 0, adder, 1)
        fg.connect(adder, 0, snk, 0)
        return fg, {"snk": snk}

    return build, a + b


def test_tags_merge_multi_input():
    build, ab = _two_sources([(5, "from_a")], [(200, "from_b")], 512, 128)
    (jt, _, _), (tt, td, _) = _both(build)
    _same_tags(jt["snk"], tt["snk"])
    assert sorted((t.offset, t.key) for t in tt["snk"]) == \
        [(5, "from_a"), (200, "from_b")]
    np.testing.assert_array_equal(td["snk"], ab)


def test_untagged_graph_has_no_tags():
    data = _rand_complex(256)
    for pkg in PKGS:
        Fg, gen, _, _ = PKGS[pkg]
        fg = Fg(batch_size=128)
        snk = gen.vector_sink()
        fg.connect(gen.vector_source(data), 0, snk, 0)
        _run(pkg, fg)
        assert snk.tags() == []


def _two_lane(block_mod, policy="one_to_one", outs=2):
    class two_lane(block_mod.SyncBlock):
        tag_policy = policy

        def __init__(self, name=None):
            super().__init__(name)
            self.add_input("in0", "cf32")
            self.add_input("in1", "cf32")
            for k in range(outs):
                self.add_output(f"out{k}", "cf32")

        def work(self, state, ins, params, nout):
            if outs == 1:
                return state, {"out0": ins["in0"] + ins["in1"]}
            return state, {"out0": ins["in0"] * 2, "out1": ins["in1"] * 3}

    return two_lane()


def test_tag_policy_one_to_one():
    """The reference's TPP_ONE_TO_ONE: tags from input port i appear only
    on output port i."""
    a, b = _rand_complex(512, 1), _rand_complex(512, 2)

    def build(pkg):
        Fg, gen, _, bm = PKGS[pkg]
        fg = Fg(batch_size=128)
        sa = gen.vector_source(a, tags=[(5, "from_a")])
        sb = gen.vector_source(b, tags=[(200, "from_b")])
        blk, s0, s1 = _two_lane(bm), gen.vector_sink(), gen.vector_sink()
        fg.connect(sa, 0, blk, 0)
        fg.connect(sb, 0, blk, 1)
        fg.connect(blk, 0, s0, 0)
        fg.connect(blk, "out1", s1, 0)
        return fg, {"s0": s0, "s1": s1}

    (jt, _, _), (tt, td, _) = _both(build)
    for k in ("s0", "s1"):
        _same_tags(jt[k], tt[k])
    assert [(t.offset, t.key) for t in tt["s0"]] == [(5, "from_a")]
    assert [(t.offset, t.key) for t in tt["s1"]] == [(200, "from_b")]
    np.testing.assert_allclose(td["s0"], a * 2, rtol=1e-6)
    np.testing.assert_allclose(td["s1"], b * 3, rtol=1e-6)


def test_tag_policy_one_to_one_arity_error():
    """ONE_TO_ONE with mismatched port counts is refused at compile time,
    by both packages."""
    for pkg in PKGS:
        Fg, gen, _, bm = PKGS[pkg]
        fg = Fg(batch_size=128)
        sa = gen.vector_source(_rand_complex(256), tags=[(0, "t")])
        sb = gen.vector_source(_rand_complex(256))
        blk, snk = _two_lane(bm, outs=1), gen.vector_sink()
        fg.connect(sa, 0, blk, 0)
        fg.connect(sb, 0, blk, 1)
        fg.connect(blk, 0, snk, 0)
        with pytest.raises(ValueError, match="one_to_one"):
            _run(pkg, fg)


def test_rich_tag_payloads():
    """The pmtf-map analog: arbitrary Python payloads ride the host-side
    registry, keyed by the int handle in the device tag plane."""
    meta = {"freq": 92.5e6, "label": "station"}
    build, _ = _chain([(3, "numeric", 1.5), (700, "rich", meta)], 1024, 256)
    (jt, _, _), (tt, _, _) = _both(build)
    _same_tags(jt["snk"], tt["snk"])
    got = {t.key: t for t in tt["snk"]}
    assert got["numeric"].value[0] == 1.5 and got["numeric"].payload is None
    assert got["rich"].offset == 700 and got["rich"].payload == meta


def test_tag_capacity_limit_no_drops():
    """Compaction bounds capacity snowballing; tags that fit still arrive."""
    build, _ = _two_sources([(5, "a0"), (300, "a1")], [(200, "b0"), (430, "b1")],
                            512, 128)
    (jt, _, jr), (tt, _, tr) = _both(build, tag_capacity_limit=2)
    _same_tags(jt["snk"], tt["snk"])
    assert sorted((t.offset, t.key) for t in tt["snk"]) == \
        [(5, "a0"), (200, "b0"), (300, "a1"), (430, "b1")]
    assert tr.stats.get("tag_drops", 0) == jr.stats.get("tag_drops", 0) == 0


def test_tag_capacity_limit_drops_counted():
    """Four tags valid in one batch through a limit of 3: the latest is
    dropped, in stream order, and counted."""
    build, _ = _two_sources([(5, "a0"), (6, "a1")], [(7, "b0"), (8, "b1")],
                            256, 256, seeds=(3, 4))
    (jt, _, jr), (tt, _, tr) = _both(build, tag_capacity_limit=3)
    _same_tags(jt["snk"], tt["snk"])
    assert tr.stats.get("tag_drops", 0) == jr.stats["tag_drops"] == 1
    assert [t.key for t in tt["snk"]] == ["a0", "a1", "b0"]


def test_compact_is_a_stable_sort_at_static_capacity():
    """compact keeps the earliest valid tags whichever port they merged in
    from, and reads nothing on the host: its outputs have the limit's
    shape whatever the values."""
    t = ttags.TagBatch(offsets=torch.tensor([9, 3, 7, 3], dtype=torch.int32),
                       keys=torch.tensor([0, 1, 2, 3], dtype=torch.int32),
                       values=torch.zeros(4, ttags.VALUE_DIM),
                       valid=torch.tensor([True, True, False, True]))
    c, dropped = ttags.compact(t, 2)
    assert c.offsets.tolist() == [3, 3] and c.keys.tolist() == [1, 3]
    assert c.valid.tolist() == [True, True] and int(dropped) == 1
    r = ttags.remap(t, 1, 4)
    assert r.offsets.tolist() == [2, 0, 1, 0]


def _fused_graph(pkg, x, tag_list, batch):
    """The fused channelizer (M = 16, 8 taps an arm, audio decimation 4,
    17 audio taps, so a shard of 64 rows holds the audio tail) over a
    tagged cf32 source: the reference's test_tags_through_fused_
    megakernel_graph, its Pallas chain in interpret mode."""
    Fg, gen, _, _ = PKGS[pkg]
    models = jmodels if pkg == "jax" else tmodels
    kw = {"interpret": True} if pkg == "jax" else {}
    src = gen.vector_source(x, tags=tag_list)
    fg, bl = models.fm_channelizer(nchans=16, taps_per_arm=8, audio_decim=4,
                                   n_samples=x.size // 64, source=src,
                                   batch_size=batch, sink="vector", fused=True,
                                   audio_taps=firdes.low_pass(
                                       1.0, 1.0, 0.1, 0.05, ntaps=17), **kw)
    return fg, bl["sink"]


@pytest.mark.parametrize("shards", [None, 4])
def test_tags_through_fused_megakernel_graph(shards):
    """Stream tags cross the fused chain with the exact rational remap
    (rate 1/(M*decim) through the adapter and the fused block); on a mesh
    of 4 logical shards too (the fused block's per-shard K3 with warm > 0),
    where the offsets must come out as they do unsharded."""
    M, decim, B, batch = 16, 4, 8192, 4096  # 64 rows a shard of 4
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(B) + 1j * rng.standard_normal(B)).astype(np.complex64)
    tag_list = [(0, "start"), (B // 2, "mid", 7.5)]
    jfg, jsnk = _fused_graph("jax", x, tag_list, batch)
    jfg.run()
    tfg, tsnk = _fused_graph("torch", x, tag_list, batch)
    tfg.run(device="cpu",
            mesh=None if shards is None else make_mesh(shards, device="cpu"))
    tags = tsnk.tags()
    _same_tags(jsnk.tags(), tags)
    assert [(t.offset, t.key) for t in tags] == \
        [(0, "start"), (B // 2 // M // decim, "mid")]
    assert tags[1].value[0] == 7.5
    assert tsnk.data().shape == (B // M // decim, M)
    assert snr_db(jsnk.data(), tsnk.data()) > 90
