"""The port's process mesh on the CPU: two OS processes joined by a
``torch.distributed`` process group over gloo
(``parallel.make_process_mesh``), each feeding and holding only its own
time shards of one global mesh, held against the JAX package's
``tests/test_multihost.py`` paths (the fused replay, K3 at warm > 0 with
the ring halo; the live source, K6 with no collectives), against the
reference's shard_map ``time_halo``, ``lax.all_to_all``, complex-sample
channelizer step (K1 a shard, the corner turn) and sharded FIR, against
its block hooks (K10, K12, K9) on its 8 simulated devices, and against
the port's own one-process runs. Each rank is a child process that imports
only the port; the JAX reference runs in the test's own process. Ranks
meet at a file under the test's tmp_path, never a fixed port.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from newsched_tpu.blocks import analog as janalog
from newsched_tpu.ops import firdes as jfirdes
from newsched_tpu.parallel import ShardedFMChannelizer as JSharded, \
    make_mesh as jmake_mesh
from newsched_tpu.parallel.halo import time_halo as jtime_halo
from newsched_tpu.parallel.sharded_fir import ShardedFirFilter as JShardedFir

from newsched_tpu_torch import Flowgraph, convert
from newsched_tpu_torch.blocks import analog as tanalog, general as tgen, \
    vector_dsp as tvd
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.ops.cuda.channelizer import arm_fold_dft
from newsched_tpu_torch.parallel import ShardedFMChannelizer, \
    ShardedFirFilter, make_mesh, make_process_mesh, planes_rows, time_halo
from newsched_tpu_torch.parallel.channelizer import PlanesFMState, \
    ShardedFMState
from newsched_tpu_torch.parallel.halo import all_to_all
from newsched_tpu_torch.parallel.mesh import ProcessMesh
from newsched_tpu_torch.testing import assemble_channels, assemble_ranks, \
    rows_reference, snr_db

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

HIGHEST = jax.lax.Precision.HIGHEST
REPO = str(Path(__file__).resolve().parents[1])
CHILD_S = 120  # each rank's own time limit

# The rank's program: ``python -c WORKER case rank world init_method dir``.
WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from newsched_tpu_torch import convert
from newsched_tpu_torch.blocks import analog, vector_dsp
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.parallel import (ShardedFMChannelizer,
                                         ShardedFirFilter, make_process_mesh,
                                         planes_rows, time_halo)
from newsched_tpu_torch.parallel.channelizer import (PlanesFMState,
                                                     ShardedFMState)
from newsched_tpu_torch.parallel.halo import all_to_all

case, rank, world, init, out = sys.argv[1:6]
rank, world = int(rank), int(world)


def save(name, a):
    np.save(f"{out}/{name}_{rank}.npy", np.asarray(a))


if case == "lone":
    make_process_mesh(8, rank=rank, world=world, init_method=init,
                      device="cpu", timeout_s=3)
    raise SystemExit("joined a group whose peer never started")

if case == "channelizer":
    M, decim, n_dev, n_rows = 16, 4, 8, 8 * 128
    mesh = make_process_mesh(n_dev, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    ch = ShardedFMChannelizer(mesh, M, firdes.prototype_channelizer_taps(M, 8),
                              firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33),
                              audio_decim=decim, demod_gain=1.1)
    rng = np.random.default_rng(33)  # the same stream in every rank
    x = (rng.standard_normal(2 * n_rows * M)
         + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64)
    rows = planes_rows(x, M)
    loc = n_rows // world
    st = ch.init_state_planes(n_rows)
    auds = []
    for b in range(2):
        mine = rows[b * n_rows + rank * loc:b * n_rows + (rank + 1) * loc]
        aud, st = ch.step_planes(torch.from_numpy(mine), st)
        auds.append(aud.numpy())
        save(f"carry{b}", st.carry.numpy())
    save("audio", np.concatenate(auds))
    # the reference's global state after batch 0, handed to this rank
    g = np.load(f"{out}/ref_state0.npz")
    st = convert.process_state_from_jax(
        PlanesFMState(g["carry"], g["prev"], g["tail"]), mesh)
    mine = rows[n_rows + rank * loc:n_rows + (rank + 1) * loc]
    save("handover", ch.step_planes(torch.from_numpy(mine), st)[0].numpy())

if case == "live":
    M, decim, n_dev = 16, 2, 8
    nout = n_dev * 64
    mesh = make_process_mesh(n_dev, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    src = vector_dsp.fm_noise_channelizer_source(
        M, None, firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17),
        audio_decim=decim, taps_per_arm=4, seed=5)
    st = src.init_state_sharded(0, nout, mesh, "t")
    params = src.param_leaves("cpu")
    auds = []
    for b in range(2):
        st, o = src.work_sharded(st, {}, params, nout, mesh, "t")
        auds.append(o["out"].numpy())
    save("live", np.concatenate(auds))
    save("group", st["group"].numpy())

if case == "halo":
    mesh = make_process_mesh(4, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    g = np.load(f"{out}/halo_in.npz")
    n = mesh.n_local
    S, H = g["x"].shape[1] // 4, g["carry"].shape[0] // 4
    carries = list(torch.from_numpy(
        g["carry"][rank * n * H:(rank + 1) * n * H]).split(H))
    for b in range(2):
        xb = torch.from_numpy(g["x"][b, rank * n * S:(rank + 1) * n * S])
        halos, carries = time_halo(list(xb.split(S)), carries, mesh)
        save(f"halo{b}", torch.cat(halos).numpy())
        save(f"hcarry{b}", torch.cat(carries).numpy())

if case == "fir":
    mesh = make_process_mesh(4, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    g = np.load(f"{out}/fir_in.npz")
    f = ShardedFirFilter(mesh, g["taps"], decim=2)
    st = f.init_state()
    B = g["x"].shape[1] // world
    ys = []
    for b in range(2):
        y, _, st = f.step(torch.from_numpy(g["x"][b, rank * B:(rank + 1) * B]),
                          None, st)
        ys.append(y.numpy())
    save("fir", np.concatenate(ys))
    save("fcarry", st.carry.numpy())

if case == "complex":
    M, decim, n_dev = 16, 4, 8
    mesh = make_process_mesh(n_dev, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    ch = ShardedFMChannelizer(mesh, M, firdes.prototype_channelizer_taps(M, 8),
                              firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33),
                              audio_decim=decim, demod_gain=1.1)
    g = np.load(f"{out}/complex_in.npz")
    x = g["x"]
    B = x.shape[0] // 3
    loc = B // world
    st = ch.init_state()
    auds = []
    for b in range(3):
        aud, st = ch.step(torch.from_numpy(
            x[b * B + rank * loc:b * B + (rank + 1) * loc]), st)
        auds.append(aud.numpy())
        for f in st._fields:
            save(f"fm_{f}{b}", getattr(st, f).numpy())
    save("complex", np.concatenate(auds))
    # the reference's global state after batch 0, handed to this rank
    st = convert.process_state_from_jax(ShardedFMState(
        g["pfb_carry"], g["demod_prev"], g["audio_tail"]), mesh)
    save("complex_handover", ch.step(torch.from_numpy(
        x[B + rank * loc:B + (rank + 1) * loc]), st)[0].numpy())

if case.startswith("hook_"):
    mesh = make_process_mesh(8, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    g = np.load(f"{out}/hook_in.npz")
    kid, nout = case[5:], int(g["nout"])
    blk = {"K10": lambda: analog.wbfm_rcv_fused(g["chan"], 0.2e6, 1e6,
                                                resamp_taps=g["rt"]),
           "K12": lambda: analog.wbfm_live_source(
               g["chan"], 0.2e6, 1e6, resamp_taps=g["rt"],
               frequency=0.2123e6),
           "K9": lambda: analog.fir_tone_source(1.0, g["fir"],
                                                frequency=0.0123, decim=4),
           }[kid]()
    st = blk.init_state_sharded(0, nout, mesh, "t")
    params = blk.param_leaves("cpu")
    outs = []
    for b in range(2):
        ins = {}
        if kid == "K10":  # the rank's own segment of the batch
            loc = g["x"].shape[1] // world
            ins = {"in": torch.from_numpy(g["x"][b, rank * loc:(rank + 1) * loc])}
        st, o = blk.work_sharded(st, ins, params, nout, mesh, "t")
        outs.append(o["out"].numpy())
    save("hook", np.concatenate(outs))
    save("hook_state", st["carry" if kid == "K10" else "phase"].numpy())

if case == "a2a":
    mesh = make_process_mesh(8, rank=rank, world=world, init_method=init,
                             device="cpu", timeout_s=60)
    g = np.load(f"{out}/a2a_in.npz")
    n = mesh.n_local
    for key, (sa, ca) in (("c", (1, 0)), ("r", (0, 1))):
        xs = [torch.from_numpy(v) for v in g[key][rank * n:(rank + 1) * n]]
        got = all_to_all(xs, split_axis=sa, concat_axis=ca, mesh=mesh)
        save(f"a2a_{key}", torch.stack(got).numpy())

print(f"rank {rank}: {case} ok", flush=True)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(tmp_path, case, world=2, ranks=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    init = f"file://{tmp_path}/group"
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, case, str(r), str(world), init,
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in (range(world) if ranks is None else ranks)]


def _wait(ps):
    """Each rank's output and exit code, each rank within CHILD_S; every
    rank killed if one is late."""
    outs = []
    try:
        for p in ps:
            outs.append((p.communicate(timeout=CHILD_S)[0], p.returncode))
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _run_ranks(tmp_path, case, world=2):
    for r, (out, rc) in enumerate(_wait(_spawn(tmp_path, case, world))):
        assert rc == 0, f"rank {r} of {case}:\n{out[-3000:]}"


def _load(tmp_path, name, world=2):
    return [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]


def _smap(fn, mesh, in_specs, out_specs):
    try:
        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)
    except TypeError:
        return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_rep=False)


def test_two_process_channelizer_matches_reference(tmp_path):
    """The twin of tests/test_multihost.py:81: 2 ranks x 4 shards of the
    fused replay (K3 at warm > 0, one launch a rank, the ring halo), 2
    batches: the assembled audio > 100 dB against the reference's
    one-process "stages" step (that test's gate) and array-equal to the
    port's one-process 8-shard step_planes; each rank's carry the
    reference's process-local shards (convert.process_state_from_jax on
    the reference's global jax.Array); a rank's second batch from the
    reference's state after the first, handed over, equal to its own."""
    M, decim, n_dev, n_rows = 16, 4, 8, 8 * 128
    taps = jfirdes.prototype_channelizer_taps(M, 8)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    rng = np.random.default_rng(33)
    x = (rng.standard_normal(2 * n_rows * M)
         + 1j * rng.standard_normal(2 * n_rows * M)).astype(np.complex64)
    rows = planes_rows(x, M)
    # the reference's 8-device megakernel state after batch 0, saved whole
    jm = JSharded(jmake_mesh(n_dev), M, taps, ataps, audio_decim=decim,
                  demod_gain=1.1, chain_method="megakernel", interpret=True)
    js0 = jax.jit(jm.step_planes)(jnp.asarray(rows[:n_rows]),
                                  jm.init_state_planes(n_rows))[1]
    g0 = jax.device_get(js0)
    np.savez(tmp_path / "ref_state0.npz", carry=g0.carry, prev=g0.prev,
             tail=g0.tail)
    ps = _spawn(tmp_path, "channelizer")
    # meanwhile, here: the reference's one-process "stages" step, the
    # port's one-process 8-shard step_planes
    js = JSharded(jmake_mesh(1), M, taps, ataps, audio_decim=decim,
                  demod_gain=1.1, chain_method="stages")
    jst, stepf, refs = js.init_state(), jax.jit(js.step), []
    one = ShardedFMChannelizer(make_mesh(n_dev, device="cpu"), M, taps, ataps,
                               audio_decim=decim, demod_gain=1.1)
    ost, single, carries = one.init_state_planes(n_rows), [], []
    for b in range(2):
        aud, jst = stepf(jnp.asarray(x[b * n_rows * M:(b + 1) * n_rows * M]),
                         jst)
        refs.append(np.asarray(aud))
        oa, ost = one.step_planes(torch.from_numpy(
            rows[b * n_rows:(b + 1) * n_rows]), ost)
        single.append(oa.numpy())
        carries.append(ost.carry.numpy())
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    got = assemble_ranks(_load(tmp_path, "audio"), 2)
    ref = np.concatenate(refs)
    assert got.shape == ref.shape == (2 * n_rows // decim, M)
    assert snr_db(ref, got) > 100
    np.testing.assert_array_equal(got, np.concatenate(single))
    for b in range(2):  # a rank's carry: its 4 blocks of the global carry
        np.testing.assert_array_equal(
            np.concatenate(_load(tmp_path, f"carry{b}")), carries[b])
    for r, c in enumerate(_load(tmp_path, "carry0")):
        mine = convert.process_state_from_jax(
            js0, types.SimpleNamespace(rank=r, world=2, device="cpu"))
        assert isinstance(mine, PlanesFMState)
        np.testing.assert_array_equal(mine.carry.numpy(), c)
        assert mine.prev.shape == (1, 2 * M) and mine.tail.shape == (32, 2 * M)
    np.testing.assert_array_equal(
        np.concatenate(_load(tmp_path, "handover")), single[1])


def test_two_process_live_source_matches_unsharded(tmp_path):
    """The twin of tests/test_multihost.py:181: the live source on 2 ranks
    x 4 shards (K6 over a rank's shards at its own group offset, no
    collectives), 2 batches: array-equal to the port's unsharded source
    (K5) and > 100 dB against the float64 golden of the same Philox rows;
    the group counter advanced by the global batch on each rank."""
    M, decim, nout = 16, 2, 8 * 64
    ps = _spawn(tmp_path, "live")
    ataps = firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=17)
    src = tvd.fm_noise_channelizer_source(M, None, ataps, audio_decim=decim,
                                          taps_per_arm=4, seed=5)
    st, params, refs = src.init_state(0, nout, "cpu"), src.param_leaves("cpu"), []
    for b in range(2):
        st, o = src.work(st, {}, params, nout)
        refs.append(o["out"].numpy())
    ref = np.concatenate(refs)
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    got = assemble_ranks(_load(tmp_path, "live"), 2)
    assert got.shape == ref.shape == (2 * nout, M)
    np.testing.assert_array_equal(got, ref)
    n_rows = 2 * nout * decim
    groups = [int(g) for g in _load(tmp_path, "group")]
    assert groups == [n_rows // noise.GROUP_ROWS] * 2
    rows = noise.gaussian_rows_plain(0, n_rows=n_rows, width=2 * M, seed=5,
                                     device="cpu").numpy()
    gold = rows_reference(rows, firdes.prototype_channelizer_taps(M, 4), ataps,
                          nchans=M, audio_decim=decim, demod_gain=1.0)
    assert snr_db(gold, got) > 100
    assert fm_chain.fm_chain_gen_warm_step.launches == 0


def test_two_process_time_halo_matches_one_process_and_reference(tmp_path):
    """2 ranks x 2 shards, 2 batches with the carries carried: each rank's
    halos and carries equal its shards' of the one-process time_halo over
    4 shards and of the reference's ppermute under shard_map."""
    S, H = 12, 5
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4 * S, 3)).astype(np.float32)
    carry = rng.standard_normal((4 * H, 3)).astype(np.float32)
    np.savez(tmp_path / "halo_in.npz", x=x, carry=carry)
    ps = _spawn(tmp_path, "halo")
    jm = jmake_mesh(4)
    jfn = jax.jit(_smap(lambda a, c: jtime_halo(a, c, "t"), jm,
                        (P("t"), P("t")), (P("t"), P("t"))))
    jc, carries = jnp.asarray(carry), list(torch.from_numpy(carry).split(H))
    want = []
    for b in range(2):
        jh, jc = jfn(jnp.asarray(x[b]), jc)
        halos, carries = time_halo(list(torch.from_numpy(x[b]).split(S)),
                                   carries)
        np.testing.assert_array_equal(torch.cat(halos).numpy(), np.asarray(jh))
        np.testing.assert_array_equal(torch.cat(carries).numpy(),
                                      np.asarray(jc))
        want.append((np.asarray(jh), np.asarray(jc)))
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    for b, (h, c) in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate(_load(tmp_path, f"halo{b}")), h)
        np.testing.assert_array_equal(
            np.concatenate(_load(tmp_path, f"hcarry{b}")), c)


def test_two_process_sharded_fir_matches_one_process_and_reference(tmp_path):
    """ShardedFirFilter on 2 ranks x 2 shards (complex samples, 33 taps,
    decimation 2), 2 batches: array-equal to its one-process 4-shard form,
    the same carries, and >= 100 dB against the reference's on its 4
    simulated devices."""
    taps = firdes.low_pass(1.0, 1.0, 0.1, 0.02, ntaps=33)
    B = 4 * 256
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((2, B)) + 1j * rng.standard_normal((2, B))
         ).astype(np.complex64)
    np.savez(tmp_path / "fir_in.npz", x=x, taps=taps)
    ps = _spawn(tmp_path, "fir")
    f = ShardedFirFilter(make_mesh(4, device="cpu"), taps, decim=2)
    jf = JShardedFir(jmake_mesh(4), taps, decim=2, method="fft")
    st, jst, ys, jys = f.init_state(), jf.init_state(), [], []
    for b in range(2):
        y, _, st = f.step(torch.from_numpy(x[b]), None, st)
        jy, _, jst = jax.jit(jf.step)(
            jax.device_put(jnp.asarray(x[b]), jf.input_sharding()), None, jst)
        ys.append(y.numpy())
        jys.append(np.asarray(jy))
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    got = assemble_ranks(_load(tmp_path, "fir"), 2)
    np.testing.assert_array_equal(got, np.concatenate(ys))
    assert snr_db(np.concatenate(jys), got) >= 100
    np.testing.assert_array_equal(np.concatenate(_load(tmp_path, "fcarry")),
                                  st.carry.numpy())


def _rand_complex(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


def _rank_rows(a, r, world=2):
    """Rank r's rows of a global state field sharded on its first axis."""
    return np.split(np.asarray(a), world)[r]


def test_two_process_complex_step_matches_reference(tmp_path):
    """The complex-sample step on 2 ranks x 4 of 8 shards (time_halo's
    ring, a PFB a shard, the corner turn in one all_to_all_single, demod
    and audio FIR a channel shard), 3 batches: each rank's channel block
    > 100 dB against its columns of the reference's 8-device shard_map
    step, and the blocks side by side equal to the port's one-process
    8-shard step bit for bit; each rank's state its part of the
    one-process state bit for bit and of the reference's within float32
    rounding; the reference's state after batch 0, handed to each rank by
    convert.process_state_from_jax, gives batch 1 (> 100 dB)."""
    M, decim, n_dev = 16, 4, 8
    taps = jfirdes.prototype_channelizer_taps(M, 8)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33)
    jm = JSharded(jmake_mesh(n_dev), M, taps, ataps, audio_decim=decim,
                  demod_gain=1.1)
    B = jm.batch_multiple() * 4
    x = _rand_complex(3 * B, 24)
    stepf, jst = jax.jit(jm.step), jm.init_state()
    refs, jstates = [], []
    for b in range(3):
        aud, jst = stepf(jax.device_put(jnp.asarray(x[b * B:(b + 1) * B]),
                                        jm.input_sharding()), jst)
        refs.append(np.asarray(aud))
        jstates.append(jst)
        if b == 0:
            g0 = jax.device_get(jst)
            np.savez(tmp_path / "complex_in.npz", x=x, **g0._asdict())
            ps = _spawn(tmp_path, "complex")
    one = ShardedFMChannelizer(make_mesh(n_dev, device="cpu"), M, taps, ataps,
                               audio_decim=decim, demod_gain=1.1)
    ost, single, ostates = one.init_state(), [], []
    for b in range(3):
        oa, ost = one.step(torch.from_numpy(x[b * B:(b + 1) * B]), ost)
        single.append(oa.numpy())
        ostates.append(ost)
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    parts = _load(tmp_path, "complex")
    ref = np.concatenate(refs)
    for r, part in enumerate(parts):
        assert part.shape == (3 * B // M // decim, M // 2)
        assert snr_db(ref[:, r * M // 2:(r + 1) * M // 2], part) > 100
    np.testing.assert_array_equal(assemble_channels(parts),
                                  np.concatenate(single))
    for b in range(3):
        for f in ShardedFMState._fields:
            for r, got in enumerate(_load(tmp_path, f"fm_{f}{b}")):
                np.testing.assert_array_equal(
                    got, _rank_rows(getattr(ostates[b], f).numpy(), r))
                np.testing.assert_allclose(
                    got, _rank_rows(getattr(jstates[b], f), r), rtol=1e-4,
                    atol=1e-4)
    for r, got in enumerate(_load(tmp_path, "complex_handover")):
        assert snr_db(refs[1][:, r * M // 2:(r + 1) * M // 2], got) > 100
        mine = convert.process_state_from_jax(
            jstates[0], types.SimpleNamespace(rank=r, world=2, device="cpu"))
        assert isinstance(mine, ShardedFMState)
        for f in ShardedFMState._fields:
            np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                          _rank_rows(getattr(g0, f), r))
    assert arm_fold_dft.launches == 0


WB_CHAN = jfirdes.low_pass(1.0, 1e6, 100e3, 60e3)
WB_RT = jfirdes.low_pass(1.0, 1.0, 0.09, 0.06)
WB_BATCH = 163840  # 8 shards of 320 folded rows (the boundary is 208)
FIR_TAPS = jfirdes.low_pass(1.0, 1.0, 0.2, 0.05, ntaps=33)


def _hook_block(pkg, kid):
    analog = janalog if pkg == "jax" else tanalog
    kw = dict(interpret=True, precision=HIGHEST) if pkg == "jax" else {}
    if kid == "K10":
        return analog.wbfm_rcv_fused(WB_CHAN, 0.2e6, 1e6, resamp_taps=WB_RT,
                                     **kw), WB_BATCH // 20
    if kid == "K12":
        return analog.wbfm_live_source(WB_CHAN, 0.2e6, 1e6, resamp_taps=WB_RT,
                                       frequency=0.2123e6, **kw), WB_BATCH // 20
    return analog.fir_tone_source(1.0, FIR_TAPS, frequency=0.0123, decim=4,
                                  **kw), 8192


def _fm_signal(n):
    t = np.arange(n) / 1e6
    return np.exp(2j * np.pi * (0.21e6 * t + 3.0 * np.sin(2 * np.pi * 1e3 * t))
                  ).astype(np.complex64)


@pytest.mark.parametrize("kid", ["K10", "K12", "K9"])
def test_two_process_block_hooks_match_one_process_and_reference(tmp_path,
                                                                 kid):
    """The sharded hooks of wbfm_rcv_fused (K10), wbfm_live_source (K12)
    and fir_tone_source (K9) on 2 ranks x 4 of 8 shards, 2 batches: each
    rank returns its own shards' output, equal to its part of the port's
    one-process 8-shard hook bit for bit and > 100 dB against the
    reference's hook on its 8 simulated devices (interpret mode); K10's
    junction of rank 1 is rank 0's last fold rows (the ring) and its carry
    the last rank's on both ranks (the broadcast); the live sources' phase
    advanced by the global batch on both; the reference's state handed to
    each rank by convert.process_state_from_jax equal to the port's."""
    blk, nout = _hook_block("torch", kid)
    x = _fm_signal(2 * WB_BATCH).reshape(2, WB_BATCH)
    np.savez(tmp_path / "hook_in.npz", x=x, nout=nout, chan=WB_CHAN, rt=WB_RT,
             fir=FIR_TAPS)
    ps = _spawn(tmp_path, f"hook_{kid}")
    mesh = make_mesh(8, device="cpu")
    st, params, one = (blk.init_state_sharded(0, nout, mesh, "t"),
                       blk.param_leaves("cpu"), [])
    jblk, _ = _hook_block("jax", kid)
    jmesh = jmake_mesh(8)
    jst = jblk.init_state_sharded(0, nout, jmesh, "t")
    jparams = {k: jnp.asarray(v) for k, v in jblk.param_leaves().items()}
    jstep = jax.jit(lambda s, i: jblk.work_sharded(s, i, jparams, nout,
                                                   jmesh, "t"))
    ref = []
    for b in range(2):
        ins = {"in": torch.from_numpy(x[b])} if kid == "K10" else {}
        st, o = blk.work_sharded(st, ins, params, nout, mesh, "t")
        one.append(o["out"].numpy())
        jst, jo = jstep(jst, {"in": jnp.asarray(x[b])} if kid == "K10" else {})
        ref.append(np.asarray(jo["out"]))
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    for r, part in enumerate(_load(tmp_path, "hook")):
        want = np.concatenate([np.split(o, 2)[r] for o in one])
        np.testing.assert_array_equal(part, want)
        got_ref = np.concatenate([np.split(o, 2)[r] for o in ref])
        assert snr_db(got_ref, part) > 100
    key = "carry" if kid == "K10" else "phase"
    for got in _load(tmp_path, "hook_state"):
        np.testing.assert_array_equal(got, st[key].numpy())
    for r in range(2):  # the reference's state, replicated, on each rank
        mine = convert.process_state_from_jax(
            jst, types.SimpleNamespace(rank=r, world=2, device="cpu"))
        assert set(mine) == set(st)
        for k, v in mine.items():
            np.testing.assert_array_equal(v.numpy(), st[k].numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_two_process_all_to_all_matches_one_process_and_reference(tmp_path,
                                                                  world):
    """The cross-rank all_to_all on 2 ranks x 4 of 8 shards (and 4 x 2,
    a rank with ranks on both sides), complex along the channelizer's
    axes (split 1, concat 0) and real along the others: each rank's
    shards get what the one-process form over 8 shards and the
    reference's tiled lax.all_to_all under shard_map give them."""
    rng = np.random.default_rng(12)
    xs = {"c": _rand_complex(8 * 6 * 16, 12).reshape(8, 6, 16),
          "r": rng.standard_normal((8, 16, 5)).astype(np.float32)}
    np.savez(tmp_path / "a2a_in.npz", **xs)
    ps = _spawn(tmp_path, "a2a", world)
    jm = jmake_mesh(8)
    want = {}
    for key, (sa, ca) in (("c", (1, 0)), ("r", (0, 1))):
        one = torch.stack(all_to_all([torch.from_numpy(v) for v in xs[key]],
                                     split_axis=sa, concat_axis=ca)).numpy()
        jfn = jax.jit(_smap(
            lambda a: jax.lax.all_to_all(a, "t", sa, ca, tiled=True), jm,
            (P("t"),), P("t")))
        jout = np.asarray(jfn(jnp.asarray(xs[key].reshape(
            -1, *xs[key].shape[2:]))))
        np.testing.assert_array_equal(one.reshape(jout.shape), jout)
        want[key] = one
    for r, (out, rc) in enumerate(_wait(ps)):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    for key, one in want.items():
        np.testing.assert_array_equal(
            np.concatenate(_load(tmp_path, f"a2a_{key}", world)), one)


def test_process_mesh_refusals(tmp_path):
    """NCCL raises naming the ROADMAP item; a world that does not divide
    the shards raises; a rank whose peer never starts raises within its
    3 s timeout; a flowgraph on a process mesh raises rather than run on
    one process's shards; the complex-sample step's state is the rank's
    part."""
    with pytest.raises(NotImplementedError, match="item 11"):
        make_process_mesh(8, rank=0, world=2, backend="nccl",
                          init_method=f"file://{tmp_path}/g", device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_process_mesh(8, rank=0, world=3,
                          init_method=f"file://{tmp_path}/g", device="cpu")
    t0 = time.monotonic()
    (out, rc), = _wait(_spawn(tmp_path, "lone", ranks=[0]))
    assert rc != 0 and "timeout" in out.lower(), out[-3000:]
    assert time.monotonic() - t0 < 60
    mesh = ProcessMesh(torch.device("cpu"), "t", 4, 0, 2, None)
    assert mesh.shape == {"t": 4} and mesh.local("t") == mesh.n_local == 2
    fg = Flowgraph()
    fg.connect(tgen.vector_source(np.zeros(64, np.float32)), 0,
               tgen.vector_sink(dtype="rf32"), 0)
    with pytest.raises(NotImplementedError, match="process mesh"):
        fg.run(device="cpu", mesh=mesh, batch_size=16)
    ch = ShardedFMChannelizer(mesh, 16, firdes.prototype_channelizer_taps(16, 8),
                              firdes.low_pass(1.0, 1.0, 0.1, 0.05, ntaps=33),
                              audio_decim=4)
    st = ch.init_state()  # the rank's 2 carry blocks and 8 channels
    assert st.pfb_carry.shape == (2 * 127,) and st.demod_prev.shape == (8,)
    assert st.audio_tail.shape == (8, 32)
