"""The port's process mesh on the CPU: two OS processes joined by a
``torch.distributed`` process group over gloo
(``parallel.make_process_mesh``), each feeding and holding only its own
time shards of one global mesh, held against the JAX package's
``tests/test_multihost.py`` paths (the fused replay, K3 at warm > 0 with
the ring halo; the live source, K6 with no collectives), against the
reference's shard_map ``time_halo`` and sharded FIR, and against the
port's own one-process runs. Each rank is a child process that imports
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

from newsched_tpu.ops import firdes as jfirdes
from newsched_tpu.parallel import ShardedFMChannelizer as JSharded, \
    make_mesh as jmake_mesh
from newsched_tpu.parallel.halo import time_halo as jtime_halo
from newsched_tpu.parallel.sharded_fir import ShardedFirFilter as JShardedFir

from newsched_tpu_torch import Flowgraph, convert
from newsched_tpu_torch.blocks import general as tgen, vector_dsp as tvd
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.parallel import ShardedFMChannelizer, \
    ShardedFirFilter, make_mesh, make_process_mesh, planes_rows, time_halo
from newsched_tpu_torch.parallel.channelizer import PlanesFMState
from newsched_tpu_torch.parallel.mesh import ProcessMesh
from newsched_tpu_torch.testing import assemble_ranks, rows_reference, snr_db

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

REPO = str(Path(__file__).resolve().parents[1])
CHILD_S = 120  # each rank's own time limit

# The rank's program: ``python -c WORKER case rank world init_method dir``.
WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from newsched_tpu_torch import convert
from newsched_tpu_torch.blocks import vector_dsp
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.parallel import (ShardedFMChannelizer,
                                         ShardedFirFilter, make_process_mesh,
                                         planes_rows, time_halo)
from newsched_tpu_torch.parallel.channelizer import PlanesFMState

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


def test_process_mesh_refusals(tmp_path):
    """NCCL raises naming the ROADMAP item; a world that does not divide
    the shards raises; a rank whose peer never starts raises within its
    3 s timeout; a flowgraph and the complex-sample step on a process mesh
    raise rather than run on one process's shards."""
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
    with pytest.raises(NotImplementedError, match="corner turn"):
        ch.init_state()
