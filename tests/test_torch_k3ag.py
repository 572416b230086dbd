"""K3ag, the banded audio stage of the fused chain (the JAX package's
``_compute_tile`` with ``ag`` > 1), held against the JAX package on the
CPU: the picker ``_pick_audio_groups`` is overridden to 2 and to 4 in both
packages, as the reference's callers override it, and K3, K5 and K6 run
their plain versions here against the reference's Pallas chain in
interpret mode. The reference's K5 and K6 draw the TPU's hardware PRNG,
which has no interpret lowering, so their rows (the port's Philox rows)
go through the reference's K3, whose ``_compute_tile`` all three share.
The banded stage sums only its nonzero taps in the order of ag = 1, so
its outputs equal ag = 1's; the tolerance asked of them is 1 ulp of
max(1, max|out|), and of the reference the existing K3 tests' (rtol 2e-4,
atol 2e-5; CHAIN_TOL of max|out| off the branch cut for K6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.ops import firdes as jfirdes, pfb as jpfb
from newsched_tpu.ops.pallas import fm_chain as jfm

from newsched_tpu_torch import models as tmodels
from newsched_tpu_torch.blocks import general as tgen
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fm_chain, launch_counters, noise
from newsched_tpu_torch.parallel import make_mesh
from newsched_tpu_torch.testing import rows_reference

HIGHEST = jax.lax.Precision.HIGHEST
GAIN = 0.7
M, L, A, DECIM, H8 = 64, 16, 65, 8, 16
CHAIN_TOL = 1e-5  # as tests/test_torch_parallel.py: of max|out|, off the cut


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(monkeypatch, ag: int) -> None:
    """Both packages' pickers return ``ag``, as a caller overrides them."""
    monkeypatch.setattr(fm_chain, "_pick_audio_groups", lambda t, d, a: ag)
    monkeypatch.setattr(jfm, "_pick_audio_groups", lambda t, d, a: ag)


def _chain():
    taps = jfirdes.prototype_channelizer_taps(M, L)
    ataps = jfirdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    fold_c = np.asarray(jpfb.pfb_arm_taps(taps, M))[::-1, ::-1].T.copy()
    return taps, fold_c, ataps


def _ulp_equal(got: torch.Tensor, ref: torch.Tensor) -> None:
    """Within 1 ulp of max(1, max|out|)."""
    tol = np.spacing(np.float32(max(1.0, float(ref.abs().max()))))
    assert float((got - ref).abs().max()) <= tol


def _jax_k3(rows: np.ndarray, fold_c, ataps, n: int):
    """The reference's K3 (interpret, HIGHEST, tile 128 as the port's) over
    consecutive batches of ``n`` rows with carried state."""
    halo = np.zeros((H8, 2 * M), np.float32)
    prev = jnp.zeros((1, 2 * M), jnp.float32)
    tail = jnp.zeros((A - 1, 2 * M), jnp.float32)
    outs = []
    for b in range(rows.shape[0] // n):
        vb = rows[b * n:(b + 1) * n]
        aud, prev, tail = jfm.fm_chain_step_planes(
            jnp.asarray(vb), jnp.asarray(halo), prev, tail, fold_c, ataps,
            DECIM, GAIN, tile=128, interpret=True, precision=HIGHEST)
        outs.append([np.asarray(x) for x in (aud, prev, tail)])
        halo = vb[-H8:]
    return outs


def _port_k3(rows: np.ndarray, consts, n: int):
    halo, prev, tail = torch.zeros(H8, 2 * M), torch.zeros(1, 2 * M), \
        torch.zeros(A - 1, 2 * M)
    outs = []
    for b in range(rows.shape[0] // n):
        vb = torch.from_numpy(rows[b * n:(b + 1) * n])
        aud, prev, tail = fm_chain.fm_chain_step_planes(vb, halo, prev, tail,
                                                        consts, DECIM, GAIN)
        outs.append([aud, prev, tail])
        halo = vb[-H8:]
    return outs


@pytest.mark.parametrize("ag", [2, 4])
def test_k3ag_plain_matches_reference_and_ag1(monkeypatch, ag):
    """K3 with ``ag`` bands, two carried batches of 512 rows: audio, prev
    and tail within the K3 tolerance of the reference's banded K3, and
    within 1 ulp of the port's ag = 1."""
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    rows = (np.random.default_rng(ag).standard_normal((1024, 2 * M)) * 0.5
            ).astype(np.float32)
    one = _port_k3(rows, consts, 512)
    _bands(monkeypatch, ag)
    got = _port_k3(rows, consts, 512)
    ref = _jax_k3(rows, fold_c, ataps, 512)
    for b in range(2):
        for name, g, r, o in zip(("audio", "prev", "tail"), got[b], ref[b],
                                 one[b]):
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} batch {b}")
            _ulp_equal(g, o)
    assert fm_chain.fm_chain_step_planes.launches == 0
    assert fm_chain.fm_chain_step_planes.ag2_launches == 0


@pytest.mark.parametrize("ag", [2, 4])
def test_k5ag_plain_matches_reference_and_ag1(monkeypatch, ag):
    """K5 with ``ag`` bands, three carried batches of 256 rows across a
    wrap of the group counter's low word: within the K3 tolerance of the
    reference's banded K3 on the same generated rows, within 1 ulp of the
    port's ag = 1, its carry the generated rows."""
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    g0, n = noise.group64(0, -2), 256

    def k5():
        st = [torch.zeros(H8, 2 * M), torch.zeros(1, 2 * M),
              torch.zeros(A - 1, 2 * M)]
        auds = []
        for b in range(3):
            aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
                g0 + b * n // 64, 0.5, *st, consts, DECIM, GAIN, n)
            st = [carry, prev, tail]
            auds.append(aud)
        return torch.cat(auds), st

    one, st1 = k5()
    _bands(monkeypatch, ag)
    got, st = k5()
    rows = (noise.gaussian_rows_plain(g0, n_rows=3 * n, width=2 * M, seed=0,
                                      device="cpu") * torch.tensor(0.5)).numpy()
    ref = np.concatenate([o[0] for o in _jax_k3(rows, fold_c, ataps, n)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)
    _ulp_equal(got, one)
    assert all(torch.equal(a, b) for a, b in zip(st, st1))
    assert torch.equal(st[0], torch.from_numpy(rows[-H8:]))
    assert fm_chain.fm_chain_gen_step.launches == 0


@pytest.mark.parametrize("ag", [2, 4])
def test_k6ag_plain_matches_reference_and_ag1(monkeypatch, ag):
    """K6 with ``ag`` bands at shard 3 of a 4-shard batch: within CHAIN_TOL
    of max|out| of the reference's banded K3 with warm > 0 on the shard's
    rows, off the branch cut, and within 1 ulp of the port's ag = 1."""
    taps, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    n_loc, warm, base = 256, 128, 3 * 256 // 64

    def k6():
        return fm_chain.fm_chain_gen_warm_step(base, 0.5, consts, DECIM, GAIN,
                                               n_loc, warm=warm, seed=4)

    one = k6()
    _bands(monkeypatch, ag)
    got = k6()
    hr = warm + H8
    rows = (noise.gaussian_rows_plain(base, n_rows=hr + n_loc, width=2 * M,
                                      seed=4, device="cpu", mask_pre=True,
                                      row0=-hr) * 0.5).numpy()
    ja, _, _ = jfm.fm_chain_step_planes(
        jnp.asarray(rows[hr:]), jnp.asarray(rows[:hr]),
        jnp.zeros((1, 2 * M), jnp.float32), jnp.zeros((A - 1, 2 * M), jnp.float32),
        fold_c, ataps, DECIM, GAIN, warm=warm, tile=128, interpret=True,
        precision=HIGHEST)
    _, bad = rows_reference(rows, taps, ataps, nchans=M, audio_decim=DECIM,
                            demod_gain=GAIN, return_risk=True)
    bad = bad[hr // DECIM:]
    ja = np.asarray(ja)
    err = np.abs(got.numpy() - ja)[~bad].max() / np.abs(ja).max()
    assert got.shape == (n_loc // DECIM, M) and err <= CHAIN_TOL
    _ulp_equal(got, one)
    assert fm_chain.fm_chain_gen_warm_step.launches == 0


def test_audio_toeplitz_equals_the_reference():
    ataps = firdes.low_pass(1.0, 1.0, 0.05, 0.0125, ntaps=A)
    for tile in (128, 64, 32):
        np.testing.assert_array_equal(fm_chain.audio_toeplitz(ataps, tile, 8),
                                      jfm.audio_toeplitz(ataps, tile, 8))


def test_picker_defaults_to_one_and_is_checked(monkeypatch):
    """The picker returns 1, as the reference's; a band count that is not
    1, 2 or 4 (32 would also leave a band of 4 rows, half an output)
    raises; K3p (pipelined) never bands."""
    assert fm_chain._pick_audio_groups(128, 8, 65) == \
        jfm._pick_audio_groups(512, 8, 65) == 1
    _, fold_c, ataps = _chain()
    consts = fm_chain.fm_chain_consts(fold_c, ataps, "cpu")
    z = torch.zeros
    args = (z(256, 2 * M), z(H8, 2 * M), z(1, 2 * M), z(A - 1, 2 * M), consts,
            DECIM, GAIN)
    one = fm_chain.fm_chain_step_planes(*args)[0]
    for ag in (3, 8, 32):
        monkeypatch.setattr(fm_chain, "_pick_audio_groups", lambda t, d, a: ag)
        with pytest.raises(ValueError, match="audio groups"):
            fm_chain.fm_chain_step_planes(*args)
        piped = fm_chain.fm_chain_step_planes(*args, pipelined=True)[0]
        assert torch.equal(piped, one)


def test_banded_launches_are_counted_per_kernel_and_band():
    names = {(f.__name__, a) for f, a in launch_counters()}
    for fn in ("fm_chain_step_planes", "fm_chain_gen_step",
               "fm_chain_gen_warm_step"):
        assert {(fn, "ag2_launches"), (fn, "ag4_launches")} <= names


def _graphs():
    """The fused replay, live and 4-shard live flagship graphs at a small
    batch (512 rows, the least the 4-shard live graph takes; 2 batches)."""
    at = firdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    rows = np.random.default_rng(5).standard_normal((512, 2 * M)).astype(
        np.float32)

    def build(source):
        src = tgen.vector_source(rows, repeat=True) if source == "replay" \
            else source
        return tmodels.fm_channelizer(
            nchans=M, taps_per_arm=L, audio_decim=DECIM, fused=True,
            source=src, batch_size=512 * M, sink="vector",
            n_samples=2 * 512 // DECIM, audio_taps=at)

    return {"replay": (lambda: build("replay"), None),
            "live": (lambda: build("live"), None),
            "live, 4 shards": (lambda: build("live"), 4)}


@pytest.mark.parametrize("name", ["replay", "live", "live, 4 shards"])
def test_flowgraphs_at_two_bands_equal_one_band(monkeypatch, name):
    """The flowgraphs whose kernels band their audio (K3, K5, K6 a shard)
    at ag = 2 equal their ag = 1 runs: the picker is read at every call."""
    build, n = _graphs()[name]
    out = {}
    for ag in (1, 2):
        monkeypatch.setattr(fm_chain, "_pick_audio_groups", lambda t, d, a: ag)
        fg, blks = build()
        fg.run(device="cpu",
               mesh=None if n is None else make_mesh(n, device="cpu"))
        out[ag] = blks["sink"].data()
    assert out[1].shape == (2 * 512 // DECIM, M)
    np.testing.assert_array_equal(out[2], out[1])
