"""Graph-level sharding on the CPU: the port's mesh of logical shards
(``parallel.make_mesh(n, device="cpu")``), its collectives, K3's warm > 0
recompute and the stateless live kernel K6 ``fm_chain_gen_warm_step``
(plain versions), the signed group arithmetic and ``mask_pre`` of the
noise stream, and every block that shards, held against the JAX package
on its simulated 8-device CPU mesh (Pallas in interpret mode, at HIGHEST
precision where the block takes it) and against the port's own unsharded
runs. Inputs come from seeded numpy generators. CUDA is never built here:
every launch count stays 0.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from newsched_tpu import models as jmodels
from newsched_tpu.blocks import analog as janalog, general as jgen, \
    vector_dsp as jvd
from newsched_tpu.ops import firdes as jfirdes, pfb as jpfb
from newsched_tpu.ops.pallas import fm_chain as jfm, noise as jnoise
from newsched_tpu.parallel import ShardedFMChannelizer as JSharded, \
    make_mesh as jmake_mesh
from newsched_tpu.parallel.halo import time_halo as jtime_halo
from newsched_tpu.runtime.compile import compile_flowgraph as jcompile
from newsched_tpu.runtime.graph import Flowgraph as JFlowgraph

from newsched_tpu_torch import Flowgraph, convert, models as tmodels
from newsched_tpu_torch.blocks import analog as tanalog, general as tgen, \
    vector_dsp as tvd
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fir_source, fm_chain, noise, \
    wbfm_chain
from newsched_tpu_torch.parallel import ShardedFMChannelizer, make_mesh, \
    planes_rows, time_halo
from newsched_tpu_torch.parallel.halo import all_to_all
from newsched_tpu_torch.parallel.mesh import make_mesh_2d
from newsched_tpu_torch.runtime.compile import compile_flowgraph
from newsched_tpu_torch.testing import rows_reference, snr_db

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

HIGHEST = jax.lax.Precision.HIGHEST
GAIN = 0.7
CHAIN_TOL = 1e-5  # plain chain vs the reference, of max|out|, off the branch cut


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return make_mesh(n, device="cpu")


def _smap(fn, mesh, in_specs, out_specs):
    try:
        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)
    except TypeError:
        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_rep=False)


def _rand_complex(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * 0.5).astype(np.complex64)


# -- the noise stream's signed group arithmetic ------------------------------

@pytest.mark.parametrize("hi,lo,off", [
    (0, 3, -5),              # crosses zero: the pre-stream region
    (0, -2, 5),              # lo crosses 2^32, the carry into hi
    (1, 1, -3),              # lo borrows from hi
    (0, 0, -1),              # the last pre-stream group
    (-1, -1, 1),             # back to group 0
    (5, 0x7FFFFFFF, 0x40000000),
])
def test_add_groups_signed_matches_reference(hi, lo, off):
    jhi, jlo = jnoise.add_groups_signed(jnp.int32(hi), jnp.int32(lo), off)
    assert noise.add_groups_signed(hi, lo, off) == (int(jhi), int(jlo))


def test_mask_pre_zeroes_exactly_the_negative_groups():
    """Rows of groups -3 .. 2 with mask_pre: the first three groups (hi < 0
    as the reference masks them) read 0, the rest equal the unmasked
    stream."""
    hi, lo = noise.add_groups_signed(0, 0, -3)
    assert hi < 0
    rows = noise.gaussian_rows_plain(noise.group64(hi, lo), n_rows=6 * 64, width=16, seed=3,
                                     device="cpu", mask_pre=True)
    plain = noise.gaussian_rows_plain(noise.group64(hi, lo), n_rows=6 * 64, width=16, seed=3,
                                      device="cpu")
    assert bool((rows[:3 * 64] == 0).all())
    assert torch.equal(rows[3 * 64:], plain[3 * 64:])
    assert bool((plain[:3 * 64] != 0).any())
    assert noise.gaussian_rows.launches == 0


@pytest.mark.parametrize("base,row0", [
    ((0, 5), -136),          # back across two groups, mid-group start
    ((1, 1), -130),          # lo borrows from hi
    ((0, -1), -1),           # the last row of the group before
])
def test_rows_at_negative_offsets_equal_rows_from_a_lower_base(base, row0):
    """The floor-division hazard of the generating kernels' row loader: a
    row before the base lies in an earlier group (floor(row / 64)), at row
    row mod 64 in it; C's truncating division would put it in the base's
    group. The same rows come from a lower base at a non-negative row."""
    back = -(row0 // 64)  # groups back to a base at or before row0
    lower = noise.add_groups_signed(*base, -back)
    got = noise.gaussian_rows_plain(noise.group64(*base), n_rows=200, width=8, seed=1,
                                    device="cpu", row0=row0)
    ref = noise.gaussian_rows_plain(noise.group64(*lower), n_rows=200, width=8, seed=1,
                                    device="cpu", row0=row0 + 64 * back)
    assert torch.equal(got, ref)


# -- the mesh and its collectives ---------------------------------------------

def test_mesh_shapes_and_device():
    """More shards than devices: all of them on the one device named."""
    m = _cpu_mesh(8)
    assert m.shape == {"t": 8} and m.size == 8 and m.axis_names == ("t",)
    assert m.device == torch.device("cpu")
    m2 = make_mesh_2d((2, 4), device="cpu")
    assert m2.shape == {"host": 2, "chip": 4} and m2.size == 8
    assert m2.device.type == "cpu"
    assert make_mesh(device="cpu").shape == {"t": 1}
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, device="cpu")


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ((), (4,)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(*args)


def test_time_halo_matches_reference_shard_map():
    """8 shards: the same halos and the same per-shard carries (shard 0's:
    the last shard's tail) as the reference's ppermute under shard_map."""
    S, H = 12, 5
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8 * S, 3)).astype(np.float32)
    carry = rng.standard_normal((8 * H, 3)).astype(np.float32)
    jm = jmake_mesh(8)
    jh, jc = _smap(lambda a, c: jtime_halo(a, c, "t"), jm, (P("t"), P("t")),
                   (P("t"), P("t")))(jnp.asarray(x), jnp.asarray(carry))
    halos, recv = time_halo(list(torch.from_numpy(x).split(S)),
                            list(torch.from_numpy(carry).split(H)))
    np.testing.assert_array_equal(torch.cat(halos).numpy(), np.asarray(jh))
    np.testing.assert_array_equal(torch.cat(recv).numpy(), np.asarray(jc))


def test_all_to_all_matches_reference():
    S, C = 6, 16
    rng = np.random.default_rng(8)
    y = rng.standard_normal((8 * S, C)).astype(np.float32)
    jm = jmake_mesh(8)
    jt = _smap(lambda a: lax.all_to_all(a, "t", 1, 0, tiled=True), jm,
               (P("t", None),), P(None, "t"))(jnp.asarray(y))
    got = all_to_all(list(torch.from_numpy(y).split(S)), 1, 0)
    assert [tuple(g.shape) for g in got] == [(8 * S, C // 8)] * 8
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), np.asarray(jt))


# -- K3 warm > 0 and K6, plain versions ---------------------------------------

def _chain(M=64, L=16, A=65, decim=8):
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    return taps, fold_c, ataps


def _off_cut_err(got, ref, rows, taps, ataps, lead, decim=8):
    """max|got - ref| / max|ref| outside the branch-cut mask of the float64
    golden of ``rows`` (its first ``lead`` rows precede the output)."""
    _, bad = rows_reference(rows, taps, ataps, nchans=64, audio_decim=decim,
                            demod_gain=GAIN, return_risk=True)
    bad = bad[lead // decim:]
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref)[~bad].max() / np.abs(ref).max())


@pytest.mark.parametrize("warm", [128, 256])
def test_k3_warm_plain_matches_reference_interpret(warm):
    """K3's warm > 0 plain version against the reference's
    fm_chain_step_planes(warm=...) in interpret mode on the same rows:
    within CHAIN_TOL of max|out| outside the golden's branch-cut mask."""
    taps, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n, H8 = 256, 16
    rng = np.random.default_rng(warm)
    rows = (rng.standard_normal((warm + H8 + n, 128)) * 0.5).astype(np.float32)
    halo, vb = rows[:warm + H8], rows[warm + H8:]
    z1, zt = np.zeros((1, 128), np.float32), np.zeros((64, 128), np.float32)
    ja, jp, jt = jfm.fm_chain_step_planes(
        jnp.asarray(vb), jnp.asarray(halo), jnp.asarray(z1), jnp.asarray(zt),
        fold_c, ataps, 8, GAIN, warm=warm, tile=128, interpret=True,
        precision=HIGHEST)
    a, p, t = fm_chain.fm_chain_step_planes(
        torch.from_numpy(vb), torch.from_numpy(halo), torch.from_numpy(z1),
        torch.from_numpy(zt), consts, 8, GAIN, warm=warm)
    assert a.shape == (n // 8, 64)
    assert _off_cut_err(a, ja, rows, taps, ataps, warm + H8) <= CHAIN_TOL
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=2e-4, atol=2e-5)
    assert fm_chain.fm_chain_step_planes.launches == 0


def test_k3_warm_validates_as_the_reference():
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    vb, z1, zt = torch.zeros(256, 128), torch.zeros(1, 128), torch.zeros(64, 128)
    for warm, tile, match in ((64, 64, "too small"), (192, 128, "multiple"),
                              (128, 128, "halo rows")):
        with pytest.raises(ValueError, match=match):
            fm_chain.fm_chain_step_planes(
                vb, torch.zeros(warm + (16 if match != "halo rows" else 8), 128),
                z1, zt, consts, 8, GAIN, warm=warm, tile=tile)


# the three shard bases of the checks: stream start, shard 3 of a 4-shard
# batch of 1024 rows, and a base two groups below 2^32 (lo wraps inside)
BASES = {"start": (0, 0), "shard3": (0, 3 * 256 // 64), "lo-wrap": (0, -2)}


def _k6_rows(base, draws, n_loc, hr):
    """The port's Philox rows of a shard's window [base - hr, base + n_loc)
    x 0.5, groups before the stream reading 0."""
    return noise.gaussian_rows_plain(noise.group64(*base), n_rows=hr + n_loc, width=128,
                                     seed=4, device="cpu", draws=draws,
                                     mask_pre=True, row0=-hr) * 0.5


@pytest.mark.parametrize("draws", [3, 2])
@pytest.mark.parametrize("where", list(BASES))
def test_k6_plain_matches_reference_on_its_rows(where, draws):
    """K6's plain version against the reference's fm_chain_step_planes
    (warm, interpret) fed the port's own Philox rows of the shard's window
    (the reference's _kernel_gen_warm draws the TPU's hardware PRNG, whose
    bits cannot be compared): within CHAIN_TOL of max|out| outside the
    golden's branch-cut mask."""
    taps, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n_loc, warm, H8 = 256, 128, 16
    got = fm_chain.fm_chain_gen_warm_step(noise.group64(*BASES[where]), 0.5, consts, 8, GAIN,
                                          n_loc, warm=warm, seed=4, draws=draws)
    rows = _k6_rows(BASES[where], draws, n_loc, warm + H8).numpy()
    ja, _, _ = jfm.fm_chain_step_planes(
        jnp.asarray(rows[warm + H8:]), jnp.asarray(rows[:warm + H8]),
        jnp.zeros((1, 128), jnp.float32), jnp.zeros((64, 128), jnp.float32),
        fold_c, ataps, 8, GAIN, warm=warm, tile=128, interpret=True,
        precision=HIGHEST)
    assert got.shape == (n_loc // 8, 64)
    assert _off_cut_err(got, ja, rows, taps, ataps, warm + H8) <= CHAIN_TOL
    assert fm_chain.fm_chain_gen_warm_step.launches == 0


@pytest.mark.parametrize("draws", [3, 2])
@pytest.mark.parametrize("where", list(BASES))
def test_k6_plain_equals_k5_stream_at_the_shard(where, draws):
    """K6 at a shard's base against the port's K5 stream sliced at the same
    rows: K5 runs two carried batches of 1024 rows from a base one batch
    below the shard's batch (the stream's start for "start" and "shard3"),
    so its state at the shard is the true stream's. The plain versions
    compute the same values, so the tolerance is CHAIN_TOL of max|out| off
    the branch cut; on the card both kernels are bit-equal
    (chip_smoke.py)."""
    taps, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n_loc, n, H8 = 256, 1024, 16
    base = BASES[where]
    b0 = (0, 0) if where != "lo-wrap" else noise.add_groups_signed(*base,
                                                                   -n // 64)
    carry, prev, tail = torch.zeros(H8, 128), torch.zeros(1, 128), \
        torch.zeros(64, 128)
    k5 = []
    for b in range(2):
        hi, lo = noise.advance_groups(*b0, b * n // 64)
        aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
            noise.group64(hi, lo), 0.5, carry, prev, tail, consts, 8, GAIN, n, seed=4,
            draws=draws)
        k5.append(aud)
    k5 = torch.cat(k5)
    r0 = 64 * (noise.group64(*base) - noise.group64(*b0))  # shard's row in k5
    ref = k5[r0 // 8:(r0 + n_loc) // 8]
    got = fm_chain.fm_chain_gen_warm_step(noise.group64(*base), 0.5, consts, 8, GAIN, n_loc,
                                          warm=128, seed=4, draws=draws)
    rows = (noise.gaussian_rows_plain(noise.group64(*b0), n_rows=2 * n, width=128, seed=4,
                                      device="cpu", draws=draws) * 0.5).numpy()
    assert _off_cut_err(got, ref, rows[:r0 + n_loc], taps, ataps, r0) <= CHAIN_TOL


@pytest.mark.parametrize("nd", [4, 8])
def test_k6_one_grid_equals_the_shards_one_by_one(nd):
    """K6 over nd shards in one call (the sharded live source's one launch
    a batch) against the nd per-shard calls, each at its own base (goff +
    d n_loc/64 groups), concatenated: bit for bit, from stream start and
    from a base past it; and against K5's stream at the same rows within
    CHAIN_TOL off the branch cut is what test_k6_plain_equals_k5_stream_at
    _the_shard holds per shard."""
    taps, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n_loc = 1024 // nd
    for g0, goff in ((0, 0), (7, 3)):
        got = fm_chain.fm_chain_gen_warm_step(
            g0, 0.5, consts, 8, GAIN, n_loc, warm=128, tile=64, seed=4,
            goff=goff, nd=nd)
        per = torch.cat([fm_chain.fm_chain_gen_warm_step(
            g0, 0.5, consts, 8, GAIN, n_loc, warm=128, tile=64, seed=4,
            goff=goff + d * n_loc // 64) for d in range(nd)])
        assert got.shape == (nd * n_loc // 8, 64)
        assert torch.equal(got, per)
    assert fm_chain.fm_chain_gen_warm_step.launches == 0


def test_k6_validates_as_the_reference():
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    for kw, match in ((dict(warm=64, tile=64), "too small"),
                      (dict(warm=192, tile=128), "multiple of tile"),
                      (dict(warm=96, tile=96), "noise group")):
        with pytest.raises(ValueError, match=match):
            fm_chain.fm_chain_gen_warm_step(0, 0.5, consts, 8, GAIN, 384,
                                            **kw)


# -- one launch over every time shard: K3 (warm > 0), K10, K12, K9 -----------

def _k3_shards(nd, past):
    """K3 with warm > 0 over nd shards of one batch: the call with nd=
    (shard 0's halo) and the nd one-shard calls, each with the warm + H8
    rows before its shard as its halo."""
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n_loc, warm, hr = 2048 // nd, 128, 128 + 16
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.standard_normal((hr + nd * n_loc, 128))
                            .astype(np.float32) * 0.5)
    if not past:  # stream start: zero rows before the batch
        rows[:hr] = 0
    vb, z1, zt = rows[hr:], torch.zeros(1, 128), torch.zeros(64, 128)
    kw = dict(warm=warm, tile=64)
    got = fm_chain.fm_chain_step_planes(vb, rows[:hr], z1, zt, consts, 8,
                                        GAIN, nd=nd, **kw)[0]
    per = [fm_chain.fm_chain_step_planes(
        vb[d * n_loc:(d + 1) * n_loc], rows[d * n_loc:d * n_loc + hr], z1,
        zt, consts, 8, GAIN, **kw)[0] for d in range(nd)]
    return got, per


def _wb_plan():
    from newsched_tpu_torch.ops import nco

    plan = wbfm_chain.WbfmChainPlan(WB_CHAN, nco.freq_to_dphase(0.2e6, 1e6),
                                    4, WB_RT, 5, 1.0)
    return plan, wbfm_chain.wbfm_consts(plan, "cpu")


def _k10_shards(nd, past):
    """K10 over nd shards: the batch folded shard by shard in one op, one
    call, the audio unfolded once; against a fold, a call and an unfold a
    shard, each from the shard before's last B8 folded rows (shard 0 from
    the carry: zeros at stream start, an earlier batch's rows past it)."""
    plan, consts = _wb_plan()
    R = 240  # folded rows a shard, >= B8 = 208
    x = torch.from_numpy(_fm_signal(64 * R * (nd + 1)))
    carry0 = (wbfm_chain.fold_planes(x[:64 * R])[R - plan.B8:] if past
              else torch.zeros(plan.B8, 128))
    x = x[64 * R:]
    aud, carry = wbfm_chain.wbfm_chain_step(wbfm_chain.fold_planes(x, nd),
                                            carry0, plan, consts, nd=nd)
    per, c = [], carry0
    for seg in x.chunk(nd):
        a, c = wbfm_chain.wbfm_chain_step(wbfm_chain.fold_planes(seg), c,
                                          plan, consts)
        per.append(wbfm_chain.unfold_audio(a))
    assert torch.equal(carry, c)
    return wbfm_chain.unfold_audio(aud, nd), per


def _k12_shards(nd, past):
    """K12 over nd shards in one call (shards 0 .. nd-1 of the batch) and
    the nd calls at shard d, from stream start and from a phase past it."""
    plan, consts = _wb_plan()
    ph, first = (0x9E3779B9, False) if past else (0, True)
    args = (ph, 0x0A3D70A4, 0.8, first, plan, consts, 240)
    got = wbfm_chain.wbfm_chain_live_step(*args, nd=nd)
    return got, [wbfm_chain.wbfm_chain_live_step(*args, shard=d)
                 for d in range(nd)]


def _k9_shards(ntaps):
    def run(nd, past):
        """K9 over nd shards in one call, unfolded once, and the nd calls
        at shard d, each unfolded: the FFT instance's taps, or past
        FFT_MAX_TAPS the partitioned instance's."""
        taps = torch.from_numpy(np.asarray(jfirdes.low_pass(
            1.0, 1.0, 0.2, 0.05, ntaps=ntaps), np.float32))
        assert isinstance(fir_source.plan(512, 4, ntaps), fir_source._Part) \
            == (ntaps > fir_source.FFT_MAX_TAPS)
        ph, first = (0x9E3779B9, False) if past else (0, True)
        args = (ph, 0x0A3D70A4, 0.8, first, taps, 4, 512)
        got = fir_source.fir_tone_step(*args, nd=nd)
        return fir_source.unfold_complex(got, nd), [
            fir_source.unfold_complex(fir_source.fir_tone_step(*args,
                                                               shard=d))
            for d in range(nd)]
    return run


ONE_LAUNCH = {"K3 warm": _k3_shards, "K10": _k10_shards,
              "K12": _k12_shards, "K9": _k9_shards(33),
              "K9 partitioned": _k9_shards(600)}


@pytest.mark.parametrize("nd", [4, 8])
@pytest.mark.parametrize("kernel", list(ONE_LAUNCH))
def test_one_launch_equals_the_shards_one_by_one(kernel, nd):
    """The sharded graphs' one launch a batch for K3 with warm > 0, K10,
    K12 and K9 (both instances): each wrapper's plain version with nd=
    equals its nd per-shard calls concatenated (as the sharded blocks made
    them before, a launch a shard), bit for bit, from stream start and
    past it; no kernel is launched on the CPU."""
    for past in (False, True):
        got, per = ONE_LAUNCH[kernel](nd, past)
        assert got.shape[0] == sum(int(p.shape[0]) for p in per)
        assert torch.equal(got, torch.cat(per)), (kernel, nd, past)
    assert fm_chain.fm_chain_step_planes.launches == 0
    assert wbfm_chain.wbfm_chain_step.launches == 0
    assert wbfm_chain.wbfm_chain_live_step.launches == 0
    assert fir_source.fir_tone_step.launches == 0
    assert fir_source.fir_tone_step.partitioned_launches == 0


def test_time_shards_validate():
    """nd must divide the batch; K3's time shards take warm > 0."""
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    z = torch.zeros
    with pytest.raises(ValueError, match="warm > 0"):
        fm_chain.fm_chain_step_planes(z(512, 128), z(16, 128), z(1, 128),
                                      z(64, 128), consts, 8, GAIN, nd=4)
    with pytest.raises(ValueError, match="multiple of nd"):
        fm_chain.fm_chain_step_planes(z(512, 128), z(144, 128), z(1, 128),
                                      z(64, 128), consts, 8, GAIN, warm=128,
                                      nd=3)
    plan, wc = _wb_plan()
    with pytest.raises(ValueError, match="nd 3"):
        wbfm_chain.wbfm_chain_step(z(1000, 128), z(plan.B8, 128), plan, wc,
                                   nd=3)
    with pytest.raises(ValueError, match="nd 0"):
        fir_source.fir_tone_step(0, 1, 0.5, True, z(33), 1, 256, nd=0)


# -- graphs under a mesh: the port sharded, unsharded, and the reference ------

def _run_port(fg, n_dev):
    mesh = None if n_dev is None else _cpu_mesh(n_dev)
    fg.run(device="cpu", mesh=mesh)


def _fused_graph(pkg, rows, M, n_out, batch_rows):
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    src = gen.vector_source(rows, dtype="rf32", vlen=(2 * M,))
    fg, blk = models.fm_channelizer(
        nchans=M, taps_per_arm=8, audio_decim=4, n_samples=n_out, source=src,
        batch_size=batch_rows * M, sink="vector", fused=True,
        audio_taps=ataps, **kw)
    return fg, blk["sink"]


@pytest.mark.parametrize("n_dev", [4, 8])
def test_fused_planes_graph_sharded(n_dev):
    """The fused flagship over replayed planes rows (M=16, the reference's
    test_fused_model_graph_mesh_matches_single), 3 batches: the sharded run
    (K3 plain per shard, warm > 0) equals the port's unsharded run, and is
    > 100 dB against the reference's sharded run."""
    M, batch_rows, nb = 16, n_dev * 64, 3
    rows = planes_rows(_rand_complex(batch_rows * M * nb, 11), M)
    n_out = batch_rows // 4 * nb
    out = {}
    for key, n in (("one", None), ("mesh", n_dev)):
        fg, snk = _fused_graph("torch", rows, M, n_out, batch_rows)
        _run_port(fg, n)
        out[key] = snk.data()
    fg, snk = _fused_graph("jax", rows, M, n_out, batch_rows)
    fg.run(mesh=jmake_mesh(n_dev))
    assert out["mesh"].shape == out["one"].shape == (n_out, M)
    np.testing.assert_array_equal(out["mesh"], out["one"])
    assert snr_db(snk.data(), out["mesh"]) > 100
    assert fm_chain.fm_chain_step_planes.launches == 0


def _staged_graph(pkg, x, n_out):
    gen, models = (jgen, jmodels) if pkg == "jax" else (tgen, tmodels)
    fg, blk = models.fm_channelizer(
        nchans=16, taps_per_arm=4, audio_decim=2, n_samples=n_out,
        source=gen.vector_source(x), batch_size=2048, sink="vector")
    return fg, blk["sink"]


@pytest.mark.parametrize("n_dev", [4, 8])
def test_staged_channelizer_graph_sharded(n_dev):
    """The staged flagship (the reference's
    test_fm_channelizer_graph_mesh_matches_single): no block of it shards
    itself, so each runs on the whole batch; equal to the unsharded run
    and > 100 dB against the reference's SPMD run."""
    x = _rand_complex(4 * 2048, 5)
    n_out = (2048 // 32) * 3 + 7
    out = {}
    for key, n in (("one", None), ("mesh", n_dev)):
        fg, snk = _staged_graph("torch", x, n_out)
        _run_port(fg, n)
        out[key] = snk.data()
    fg, snk = _staged_graph("jax", x, n_out)
    fg.run(mesh=jmake_mesh(n_dev))
    np.testing.assert_array_equal(out["mesh"], out["one"])
    assert snr_db(snk.data(), out["mesh"]) > 100


WB_CHAN = jfirdes.low_pass(1.0, 1e6, 100e3, 60e3)
WB_RT = jfirdes.low_pass(1.0, 1.0, 0.09, 0.06)
WB_BATCH = 163840  # 8 shards of 320 folded rows (the boundary is 208)


def _wb_graph(pkg, kind, x=None, nb=3):
    gen, analog, FG = ((jgen, janalog, JFlowgraph) if pkg == "jax"
                       else (tgen, tanalog, Flowgraph))
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    if kind == "fused":
        fg = FG(batch_size=WB_BATCH)
        last = analog.wbfm_rcv_fused(WB_CHAN, 0.2e6, 1e6, resamp_taps=WB_RT,
                                     **kw)
        fg.connect(gen.vector_source(x), 0, last, 0)
    else:
        fg = FG(batch_size=WB_BATCH // 20)
        last = analog.wbfm_live_source(WB_CHAN, 0.2e6, 1e6, resamp_taps=WB_RT,
                                       frequency=0.2123e6, **kw)
    hd = gen.head(WB_BATCH * nb // 20, dtype="rf32")
    snk = gen.vector_sink(dtype="rf32")
    fg.connect(last, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, snk


def _fm_signal(n):
    t = np.arange(n) / 1e6
    return np.exp(2j * np.pi * (0.21e6 * t + 3.0 * np.sin(2 * np.pi * 1e3 * t))
                  ).astype(np.complex64)


def _loop_graphs():
    """The four sharded graphs (K3 with warm > 0, K10, K12, K9) as
    builders of (flowgraph, sink)."""
    rows = planes_rows(_rand_complex(3 * 512 * 16, 3), 16)
    x = _fm_signal(WB_BATCH * 3)
    return {"fused planes": lambda: _fused_graph("torch", rows, 16, 3 * 128,
                                                 512),
            "wbfm fused": lambda: _wb_graph("torch", "fused", x),
            "wbfm live": lambda: _wb_graph("torch", "live"),
            "fir live": lambda: _fir_graph("torch")}


@pytest.mark.parametrize("kind", ["fused planes", "wbfm fused", "wbfm live",
                                  "fir live"])
def test_sharded_graphs_equal_their_per_shard_loops(kind):
    """Each sharded graph in its one launch a batch equals the same graph
    run by the per-shard loop it ran before (the cut copy in
    probes/stages.py that chip_smoke.py phase 29 times beside it), on 4
    shards, bit for bit."""
    from newsched_tpu_torch.probes import stages

    out = {}
    for form in ("one launch", "loop"):
        with (stages.shard_loops() if form == "loop"
              else contextlib.nullcontext()):
            fg, snk = _loop_graphs()[kind]()
            _run_port(fg, 4)
        out[form] = snk.data()
    assert out["one launch"].size > 0
    np.testing.assert_array_equal(out["one launch"], out["loop"])


def test_sharded_steps_time_each_form_in_turns():
    """probes/stages.py ``sharded_steps`` (chip_smoke.py phase 29b) on the
    CPU at a small size: a record for each cell unsharded and for each
    shard count in one launch and in the loop, each timed twice (forward,
    then backward), the best its ms."""
    from newsched_tpu_torch.probes import stages

    rows = planes_rows(_rand_complex(512 * 16, 5), 16)

    def fused():
        return tmodels.fm_channelizer(
            nchans=16, taps_per_arm=8, audio_decim=4, fused=True,
            source=tgen.vector_source(rows, repeat=True),
            batch_size=512 * 16, sink="null",
            audio_taps=jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17))[0]

    recs = stages.sharded_steps({"fused": (fused, 512 * 16)}, shards=(4,),
                                device="cpu")
    assert [(r["shards"], r["form"]) for r in recs] == [
        (1, "one launch"), (4, "one launch"), (4, "loop")]
    assert all(len(r["ms_all"]) == 2 and r["ms"] == min(r["ms_all"]) > 0
               for r in recs)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("kind", ["fused", "live"])
def test_wbfm_blocks_sharded(kind, n_dev):
    """wbfm_rcv_fused (cf32; K10 per shard, each shard's junction from its
    neighbour's boundary rows) and wbfm_live_source (K12 per shard at its
    own phase offset), 3 batches: equal to the unsharded run, > 100 dB
    against the reference's sharded run."""
    x = _fm_signal(WB_BATCH * 3) if kind == "fused" else None
    out = {}
    for key, n in (("one", None), ("mesh", n_dev)):
        fg, snk = _wb_graph("torch", kind, x)
        _run_port(fg, n)
        out[key] = snk.data()
    fg, snk = _wb_graph("jax", kind, x)
    fg.run(mesh=jmake_mesh(n_dev))
    assert out["mesh"].shape == (WB_BATCH * 3 // 20,)
    np.testing.assert_array_equal(out["mesh"], out["one"])
    assert snr_db(snk.data(), out["mesh"]) > 100
    assert wbfm_chain.wbfm_chain_step.launches == 0
    assert wbfm_chain.wbfm_chain_live_step.launches == 0


def _fir_graph(pkg, nb=3, batch=8192):
    gen, analog, FG = ((jgen, janalog, JFlowgraph) if pkg == "jax"
                       else (tgen, tanalog, Flowgraph))
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    taps = jfirdes.low_pass(1.0, 1.0, 0.2, 0.05, ntaps=33)
    src = analog.fir_tone_source(1.0, taps, frequency=0.0123, decim=4, **kw)
    hd, snk = gen.head(batch * nb), gen.vector_sink()
    fg = FG(batch_size=batch)
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, snk


@pytest.mark.parametrize("n_dev", [4, 8])
def test_fir_tone_source_sharded(n_dev):
    """fir_tone_source (K9 per shard at its own phase offset), 3 batches:
    equal to the unsharded run, > 100 dB against the reference's sharded
    run."""
    out = {}
    for key, n in (("one", None), ("mesh", n_dev)):
        fg, snk = _fir_graph("torch")
        _run_port(fg, n)
        out[key] = snk.data()
    fg, snk = _fir_graph("jax")
    fg.run(mesh=jmake_mesh(n_dev))
    assert out["mesh"].shape == (3 * 8192,)
    np.testing.assert_array_equal(out["mesh"], out["one"])
    assert snr_db(snk.data(), out["mesh"]) > 100
    assert fir_source.fir_tone_step.launches == 0


def _live_fm(n_dev, nout, nb, M=16, decim=2):
    fg, blk = tmodels.fm_channelizer(
        nchans=M, taps_per_arm=4, audio_decim=decim, n_samples=nout * nb,
        source="live", batch_size=nout * decim * M, sink="vector", fused=True)
    _run_port(fg, n_dev)
    return blk["sink"].data(), blk["audio_taps"]


@pytest.mark.parametrize("n_dev", [4, 8])
def test_live_flagship_sharded_equals_unsharded(n_dev):
    """The live flagship (the reference's
    test_live_fm_source_graph_mesh_matches_single; port only, since the
    reference's CPU stream is threefry, the port's Philox): K6 per shard at
    base group + d * n_loc / 64, 3 batches from stream start, equal to the
    unsharded run (K5)."""
    nout = n_dev * 64
    ref, _ = _live_fm(None, nout, 3)
    got, _ = _live_fm(n_dev, nout, 3)
    assert got.shape == ref.shape == (3 * nout, 16)
    np.testing.assert_array_equal(got, ref)
    assert fm_chain.fm_chain_gen_warm_step.launches == 0


def test_live_flagship_sharded_vs_float64_golden():
    """The counterpart of test_live_fm_source_vs_float64_golden_sharded:
    the sharded stream against the float64 golden of the same Philox rows,
    > 100 dB."""
    M, decim, nout = 16, 2, 512
    got, ataps = _live_fm(8, nout, 2)
    n_rows = nout * decim * 2
    rows = noise.gaussian_rows_plain(0, n_rows=n_rows, width=2 * M, seed=0,
                                     device="cpu").numpy() * 0.5
    taps = firdes.prototype_channelizer_taps(M, 4)
    ref = rows_reference(rows, taps, ataps, nchans=M, audio_decim=decim,
                         demod_gain=1.0 / (2 * np.pi * 0.3))
    assert snr_db(ref[:got.shape[0]], got) > 100


# -- ShardedFMChannelizer against the reference --------------------------------

def _sharded_pair(n_dev, **kw):
    M, L, decim = 16, 8, 4
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    j = JSharded(jmake_mesh(n_dev), M, taps, ataps, audio_decim=decim,
                 demod_gain=1.1, **kw)
    kw.pop("interpret", None)
    kw.pop("chain_method", None)  # the port always takes the "auto" rule
    t = ShardedFMChannelizer(_cpu_mesh(n_dev), M, taps, ataps,
                             audio_decim=decim, demod_gain=1.1, **kw)
    return j, t


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_channelizer_step_matches_reference(n_dev):
    """step (time_halo, per-shard PFB, the all_to_all corner turn, demod
    and audio FIR per channel shard), 3 batches: > 100 dB against the
    reference's step on its mesh, states within float32 rounding, and
    equal to the port's one-shard step."""
    j, t = _sharded_pair(n_dev)
    one = ShardedFMChannelizer(_cpu_mesh(1), 16, jfirdes.prototype_channelizer_taps(16, 8),
                               t.audio_taps, audio_decim=4, demod_gain=1.1)
    B = j.batch_multiple() * 4
    x = _rand_complex(3 * B, 21)
    js, ts, os_ = j.init_state(), t.init_state(), one.init_state()
    got, ref, single = [], [], []
    for b in range(3):
        xb = x[b * B:(b + 1) * B]
        ja, js = jax.jit(j.step)(jax.device_put(jnp.asarray(xb),
                                                j.input_sharding()), js)
        ta, ts = t.step(torch.from_numpy(xb), ts)
        oa, os_ = one.step(torch.from_numpy(xb), os_)
        ref.append(np.asarray(ja))
        got.append(ta.numpy())
        single.append(oa.numpy())
    assert snr_db(np.concatenate(ref), np.concatenate(got)) > 100
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(single),
                               rtol=0, atol=1e-5)
    for a, b in zip(ts, js):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_one_shard_step_takes_the_fused_kernel_form():
    """One shard at 64 channels (2M = 128 lanes): step runs the fused
    kernel on the batch's commutator rows, as the reference's "auto" rule
    picks; 3 batches: > 100 dB against the reference's megakernel step
    (interpret mode), states within float32 rounding, and within 1e-5 of
    the port's staged one-shard form."""
    M, L, decim = 64, 4, 4
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    j = JSharded(jmake_mesh(1), M, taps, ataps, audio_decim=decim,
                 demod_gain=1.1, interpret=True, chain_precision=HIGHEST)
    assert j.chain_method == "megakernel"
    t = ShardedFMChannelizer(_cpu_mesh(1), M, taps, ataps, audio_decim=decim,
                             demod_gain=1.1)
    B = t.batch_multiple() * 32  # 128 commutator rows a batch
    x = _rand_complex(3 * B, 41)
    js, ts, ss = j.init_state(), t.init_state(), t.init_state()
    got, ref, staged = [], [], []
    for b in range(3):
        xb = x[b * B:(b + 1) * B]
        ja, js = jax.jit(j.step)(jnp.asarray(xb), js)
        ta, ts = t.step(torch.from_numpy(xb), ts)
        sa, ss = t._single_step(torch.from_numpy(xb), ss)
        ref.append(np.asarray(ja))
        got.append(ta.numpy())
        staged.append(sa.numpy())
    assert got[0].shape == (B // M // decim, M)
    assert snr_db(np.concatenate(ref), np.concatenate(got)) > 100
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(staged),
                               rtol=0, atol=1e-5)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    assert fm_chain.fm_chain_step_planes.launches == 0


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_step_planes_matches_reference(n_dev):
    """step_planes (K3 per shard, warm > 0, after a time_halo of warm + H8
    rows), 3 batches: > 100 dB against the reference's (interpret mode),
    the same carry, and equal to the port's one-shard step_planes."""
    j, t = _sharded_pair(n_dev, chain_method="megakernel", interpret=True)
    one = ShardedFMChannelizer(_cpu_mesh(1), 16, jfirdes.prototype_channelizer_taps(16, 8),
                               t.audio_taps, audio_decim=4, demod_gain=1.1)
    n_rows = n_dev * 128
    rows = planes_rows(_rand_complex(3 * n_rows * 16, 33), 16)
    js, ts = j.init_state_planes(n_rows), t.init_state_planes(n_rows)
    os_ = one.init_state_planes(n_rows)
    assert tuple(ts.carry.shape) == tuple(js.carry.shape)
    got, ref, single = [], [], []
    for b in range(3):
        rb = rows[b * n_rows:(b + 1) * n_rows]
        ja, js = jax.jit(j.step_planes)(jnp.asarray(rb), js)
        ta, ts = t.step_planes(torch.from_numpy(rb), ts)
        oa, os_ = one.step_planes(torch.from_numpy(rb), os_)
        ref.append(np.asarray(ja))
        got.append(ta.numpy())
        single.append(oa.numpy())
    assert snr_db(np.concatenate(ref), np.concatenate(got)) > 100
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(single))
    np.testing.assert_array_equal(ts.carry.numpy(), np.asarray(js.carry))


def test_sharded_states_from_jax_hand_over_mid_stream():
    """The reference's PlanesFMState and ShardedFMState after one batch
    become the port's field by field; the port's second batch from them
    matches the reference's second batch."""
    j, t = _sharded_pair(4, chain_method="megakernel", interpret=True)
    n_rows = 4 * 128
    rows = planes_rows(_rand_complex(2 * n_rows * 16, 34), 16)
    js = j.init_state_planes(n_rows)
    _, js = jax.jit(j.step_planes)(jnp.asarray(rows[:n_rows]), js)
    ts = convert.state_from_jax(jax.device_get(js), "cpu")
    assert type(ts).__name__ == "PlanesFMState"
    ja, _ = jax.jit(j.step_planes)(jnp.asarray(rows[n_rows:]), js)
    t._planes_setup(n_rows)
    ta, _ = t.step_planes(torch.from_numpy(rows[n_rows:]), ts)
    assert snr_db(np.asarray(ja), ta.numpy()) > 100

    j, t = _sharded_pair(4)
    B = j.batch_multiple() * 4
    x = _rand_complex(2 * B, 35)
    _, js = jax.jit(j.step)(jnp.asarray(x[:B]), j.init_state())
    ts = convert.state_from_jax(jax.device_get(js), "cpu")
    assert type(ts).__name__ == "ShardedFMState"
    ja, _ = jax.jit(j.step)(jnp.asarray(x[B:]), js)
    ta, _ = t.step(torch.from_numpy(x[B:]), ts)
    assert snr_db(np.asarray(ja), ta.numpy()) > 100


# -- compile-time geometry and the error paths ---------------------------------

def test_mesh_batch_matches_reference_compile():
    """Under a mesh the batch is a multiple of the time axis, as the
    reference's compiler makes it."""
    def graph(pkg):
        gen, FG = (jgen, JFlowgraph) if pkg == "jax" else (tgen, Flowgraph)
        fg = FG()
        src = gen.vector_source(_rand_complex(4096, 3))
        snk = gen.vector_sink()
        fg.connect(src, 0, snk, 0)
        return fg

    for n in (4, 8):
        t = compile_flowgraph(graph("torch"), batch_size=1001, mesh=_cpu_mesh(n))
        j = jcompile(graph("jax"), batch_size=1001, mesh=jmake_mesh(n))
        assert t.batch_ref == j.batch_ref and t.batch_ref % n == 0
        assert t.mesh is not None and t.time_axis == "t"


def test_unshardable_blocks_raise():
    """sig_source_folded under a mesh raises "does not shard", as the
    reference; so does wbfm_rcv_fused(input_format="folded")'s sharded
    step."""
    src = tanalog.sig_source_folded(1e6, frequency=1000.0)
    hd = tgen.head(1024, dtype="rf32", vlen=(128,))
    snk = tgen.vector_sink(dtype="rf32", vlen=(128,))
    fg = Flowgraph(batch_size=1024)
    fg.connect(src, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    with pytest.raises(ValueError, match="does not shard"):
        fg.run(device="cpu", mesh=_cpu_mesh(8))
    blk = tanalog.wbfm_rcv_fused(WB_CHAN, 0.2e6, 1e6, input_format="folded")
    with pytest.raises(NotImplementedError, match="does not shard"):
        blk.work_sharded(blk.init_state(0, 0, "cpu"), {"in": None},
                         blk.param_leaves("cpu"), 64, _cpu_mesh(8), "t")


def test_live_flagship_sharded_geometry_errors():
    """Bad mesh/batch combinations raise at compile time with the
    reference's messages (test_live_fm_sharded_geometry_errors)."""
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = tvd.fm_noise_channelizer_source(16, None, ataps, audio_decim=2,
                                          taps_per_arm=4)
    jsrc = jvd.fm_noise_channelizer_source(16, None, ataps, audio_decim=2,
                                           taps_per_arm=4, interpret=True)
    for nout, match in ((36, "multiple"), (35, "divisible"), (2304, "tile")):
        with pytest.raises(ValueError, match=match):
            src.init_state_sharded(0, nout, _cpu_mesh(8), "t")
        with pytest.raises(ValueError, match=match):
            jsrc.init_state_sharded(0, nout, jmake_mesh(8), "t")


def test_run_device_must_agree_with_the_mesh():
    fg, _ = tmodels.fm_channelizer(
        nchans=16, taps_per_arm=4, audio_decim=2, n_samples=64, source="live",
        batch_size=64 * 2 * 16, sink="vector", fused=True)
    with pytest.raises(ValueError, match="contradicts the mesh"):
        fg.run(mesh=_cpu_mesh(4))  # device defaults to the card
