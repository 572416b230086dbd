"""The port's digital loops (ops/loops.py: S1 costas_loop and S2
clock_recovery_mm, their plain versions on the CPU) and digital blocks,
held against the JAX package on the same numpy inputs: the loops within
1e-4 of max|y| over 4096 samples with the reference's state carried across
by convert.state_from_jax, and against jax.vmap of the reference at three
streams; the blocks (twins of tests/test_aux.py's digital round trip and
diff codec) bit-equal. On a CUDA tensor a wrapper launches its kernel or
raises: when the kernels cannot be built, it raises."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu import Flowgraph as JFlowgraph
from newsched_tpu.blocks import digital as jdig, general as jgen
from newsched_tpu.ops import loops as jl

from newsched_tpu_torch import convert
from newsched_tpu_torch.blocks import digital as tdig, general as tgen
from newsched_tpu_torch.ops import loops as tl
from newsched_tpu_torch.ops.cuda import _build, loops as kloops
from newsched_tpu_torch.runtime.graph import Flowgraph as TFlowgraph

TOL = 1e-4  # of max|y|: the loops contract sin/cos's last-ulp differences
N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psk_stream(order: int, n: int, seed: int, phase: float = 0.3,
                sigma: float = 0.05, streams: tuple = ()) -> np.ndarray:
    """Symbols of the detector's own constellation (BPSK, diagonal QPSK,
    8PSK), rotated by ``phase`` with a slow drift, plus noise."""
    rng = np.random.default_rng(seed)
    rot = {2: 0.0, 4: np.pi / 4, 8: 0.0}[order]
    k = rng.integers(0, order, streams + (n,))
    drift = 2e-4 * np.arange(n)
    s = np.exp(1j * (2 * np.pi * k / order + rot + phase + drift))
    s = s + sigma * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
    return s.astype(np.complex64)


def _rrc_stream(sps: int, n: int, seed: int, streams: tuple = ()) -> np.ndarray:
    """Diagonal QPSK through an RRC pulse shaper at sps, delayed by a
    fractional 0.4 sample, with a little noise."""
    from newsched_tpu_torch.models import rrc_taps

    rng = np.random.default_rng(seed)
    taps = rrc_taps(sps)
    out = []
    for _ in range(int(np.prod(streams, dtype=np.int64))):
        k = rng.integers(0, 4, n // sps + len(taps))
        up = np.zeros(len(k) * sps, complex)
        up[::sps] = np.exp(1j * (np.pi / 2 * k + np.pi / 4))
        x = np.convolve(up, taps)[len(taps):len(taps) + n + 1]
        x = x[:-1] + 0.4 * (x[1:] - x[:-1])
        out.append(x + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return np.asarray(out, np.complex64).reshape(streams + (n,))


def _close(ref, got, what: str):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, (what, err)


# -- the loops' helpers -------------------------------------------------------

def test_loop_helpers_match_reference():
    """loop_coeffs, _wrap_phase (round half to even), _costas_error and
    _slicer against the reference's, bit-equal."""
    for bw in (0.01, 0.06, 0.3):
        assert tl.loop_coeffs(bw) == jl.loop_coeffs(bw)
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.uniform(-40, 40, 1000),
                        np.pi * np.arange(-5, 6)]).astype(np.float32)
    np.testing.assert_array_equal(tl._wrap_phase(torch.from_numpy(p)).numpy(),
                                  np.asarray(jl._wrap_phase(jnp.asarray(p))))
    y = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
    y[:4] = [0, -0.0 + 0j, 1j, -1]
    yt = torch.from_numpy(y)
    for order in (2, 4, 8):
        np.testing.assert_array_equal(
            tl._costas_error(yt.real, yt.imag, order).numpy(),
            np.asarray(jl._costas_error(jnp.asarray(y), order)))
    np.testing.assert_array_equal(tl._slicer(yt).numpy(),
                                  np.asarray(jl._slicer(jnp.asarray(y))))
    with pytest.raises(ValueError, match="2, 4, or 8"):
        tl.costas_loop(tl.costas_init_state(device="cpu"), yt, 0.06, order=3)


# -- S1 costas_loop -------------------------------------------------------------

@pytest.mark.parametrize("bw_kind", ["host", "tensor"])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_loop_matches_reference(order, bw_kind):
    """2048 samples through the reference, its state carried across, then
    4096 more through both (a host loop_bw designed in float64, a tensor
    one in float32 where it lies): outputs and final state within 1e-4."""
    x = _psk_stream(order, 2048 + N, seed=order)
    bw = 0.06 if bw_kind == "host" else np.float32(0.06)
    jst, _ = jl.costas_loop(jl.costas_init_state(0.05, 1e-3),
                            jnp.asarray(x[:2048]), bw, order=order)
    tst = convert.state_from_jax(jst, "cpu")
    assert isinstance(tst, tl.CostasState) and tst.phase.dtype == torch.float32
    assert float(tst.phase) == float(jst.phase)  # radians, not an NCO phase
    tbw = bw if bw_kind == "host" else torch.tensor(bw)
    jst, jy = jl.costas_loop(jst, jnp.asarray(x[2048:]), bw, order=order)
    tst, ty = tl.costas_loop(tst, torch.from_numpy(x[2048:]), tbw, order=order)
    _close(jy, ty.numpy(), f"costas order {order}")
    for f in ("phase", "freq"):
        assert abs(float(getattr(jst, f)) - float(getattr(tst, f))) <= TOL, f


def test_costas_loop_matches_vmapped_reference():
    """Three streams at once (leading stream dims, the reference's vmap)."""
    x = _psk_stream(4, N, seed=7, streams=(3,))
    init = jl.CostasState(phase=jnp.float32([0.0, 0.2, -0.1]),
                          freq=jnp.float32([0.0, 1e-3, -1e-3]))
    jst, jy = jax.vmap(lambda s, v: jl.costas_loop(s, v, 0.06, order=4))(
        init, jnp.asarray(x))
    tst, ty = tl.costas_loop(convert.state_from_jax(init, "cpu"),
                             torch.from_numpy(x), 0.06, order=4)
    _close(jy, ty.numpy(), "costas vmap")
    assert ty.shape == (3, N) and tst.phase.shape == (3,)
    np.testing.assert_allclose(np.asarray(jst.phase), tst.phase.numpy(), atol=TOL)


def test_costas_loop_split_invariance():
    """Two batches equal one, bit for bit (the carried state is exact)."""
    x = torch.from_numpy(_psk_stream(8, 2048, seed=3))
    st0 = tl.costas_init_state(device="cpu")
    _, one = tl.costas_loop(st0, x, 0.06, order=8)
    st, a = tl.costas_loop(st0, x[:768], 0.06, order=8)
    _, b = tl.costas_loop(st, x[768:], 0.06, order=8)
    assert torch.equal(torch.cat([a, b]), one)


# -- S2 clock_recovery_mm -------------------------------------------------------

def _mm_compare(jst, tst, jy, ty, what: str):
    _close(jy, ty.numpy(), what)
    np.testing.assert_array_equal(np.asarray(jst.hist), tst.hist.numpy())
    # a 1-ulp difference can move floor(step) by one: then pos and mu differ
    # while pos + mu agrees
    jp = np.asarray(jst.pos) + np.asarray(jst.mu, np.float64)
    tp = tst.pos.numpy() + tst.mu.numpy().astype(np.float64)
    np.testing.assert_allclose(jp, tp, atol=TOL)
    for f in ("omega", "p1", "p2", "c1", "c2"):
        np.testing.assert_allclose(np.asarray(getattr(jst, f)),
                                   getattr(tst, f).numpy(), atol=TOL)


@pytest.mark.parametrize("gain_kind", ["host", "tensor"])
@pytest.mark.parametrize("sps", [2, 4])
def test_clock_recovery_mm_matches_reference(sps, gain_kind):
    """A batch through the reference, its state carried across, then 4096
    samples in 4 batches through both: symbols within 1e-4 of max|y|, the
    state within the same (pos + mu, not pos alone)."""
    gm = 0.1 if sps == 4 else 0.05
    x = _rrc_stream(sps, 1024 + N, seed=sps, streams=(1,))[0]
    jst, _ = jl.clock_recovery_mm(jl.mm_init_state(sps), jnp.asarray(x[:1024]),
                                  sps, 0.25 * gm * gm, gm)
    tst = convert.state_from_jax(jst, "cpu")
    assert isinstance(tst, tl.MMState) and tst.pos.dtype == torch.int64
    g = ((0.25 * gm * gm, gm) if gain_kind == "host" else
         (torch.tensor(np.float32(0.25 * gm * gm)), torch.tensor(np.float32(gm))))
    jys, tys = [], []
    for i in range(1024, 1024 + N, 1024):
        jst, jy = jl.clock_recovery_mm(jst, jnp.asarray(x[i:i + 1024]), sps,
                                       0.25 * gm * gm, gm)
        tst, ty = tl.clock_recovery_mm(tst, torch.from_numpy(x[i:i + 1024]),
                                       sps, *g)
        jys.append(np.asarray(jy))
        tys.append(ty)
    _mm_compare(jst, tst, np.concatenate(jys), torch.cat(tys), f"mm sps {sps}")


def test_clock_recovery_mm_matches_vmapped_reference():
    sps, gm = 4, 0.1
    x = _rrc_stream(sps, N, seed=11, streams=(3,))
    init = jax.vmap(lambda _: jl.mm_init_state(sps))(jnp.arange(3))
    jst, jy = jax.vmap(lambda s, v: jl.clock_recovery_mm(
        s, v, sps, 0.25 * gm * gm, gm))(init, jnp.asarray(x))
    tst, ty = tl.clock_recovery_mm(convert.state_from_jax(init, "cpu"),
                                   torch.from_numpy(x), sps, 0.25 * gm * gm, gm)
    assert ty.shape == (3, N // sps) and tst.hist.shape == (3, 16 * sps + 2)
    _mm_compare(jst, tst, jy, ty, "mm vmap")


def test_clock_recovery_mm_split_invariance_and_rate():
    """Two batches equal one bit for bit (also a batch shorter than the
    history); a batch that sps does not divide raises."""
    sps = 4
    x = torch.from_numpy(_rrc_stream(sps, 2048, seed=5, streams=(1,))[0])
    st0 = tl.mm_init_state(sps, device="cpu")
    _, one = tl.clock_recovery_mm(st0, x, sps, 0.0025, 0.1)
    st, a = tl.clock_recovery_mm(st0, x[:40], sps, 0.0025, 0.1)
    st, b = tl.clock_recovery_mm(st, x[40:1024], sps, 0.0025, 0.1)
    _, c = tl.clock_recovery_mm(st, x[1024:], sps, 0.0025, 0.1)
    assert torch.equal(torch.cat([a, b, c]), one)
    with pytest.raises(ValueError, match="multiple of sps"):
        tl.clock_recovery_mm(st0, x[:10], sps, 0.0025, 0.1)


# -- on a CUDA tensor: the kernel, or an error ------------------------------------

def test_cuda_tensors_reach_the_kernels_or_raise(monkeypatch):
    """With `_build.build` failing (no nvcc), S1 and S2 on device tensors (meta
    tensors stand in for the card) raise, and never return the plain
    version's result."""
    def no_build():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "build", no_build)
    z = dict(device="meta")
    x = torch.empty(1, 64, dtype=torch.complex64, **z)
    f = torch.empty(1, dtype=torch.float32, **z)
    with pytest.raises(_build.KernelBuildError):
        kloops.costas_loop(x, f, f, None, 0.1, 0.01, 4, 1.0)
    c = torch.empty(1, dtype=torch.complex64, **z)
    with pytest.raises(_build.KernelBuildError):
        kloops.clock_recovery_mm(
            x, torch.empty(1, 66, dtype=torch.complex64, **z),
            torch.empty(1, dtype=torch.int64, **z), f, f, c, c, c, c, 4,
            0.0025, 0.1, 0.005)
    assert kloops.costas_loop.launches == 0
    assert kloops.clock_recovery_mm.launches == 0


# -- the digital blocks -------------------------------------------------------------

def _graph(pkg, chain, data, dtype, out_dtype, batch):
    FG, gen = (JFlowgraph, jgen) if pkg == "jax" else (TFlowgraph, tgen)
    fg = FG(batch_size=batch)
    src = gen.vector_source(data, dtype=dtype)
    snk = gen.vector_sink(dtype=out_dtype)
    blocks = [src, *chain, snk]
    for a, b in zip(blocks, blocks[1:]):
        fg.connect(a, 0, b, 0)
    if pkg == "jax":
        fg.run()
    else:
        fg.run(device="cpu")
    return snk.data()


@pytest.mark.parametrize("name", ["bpsk", "qpsk", "psk8", "qam16"])
def test_digital_roundtrip(name):
    """Twin of tests/test_aux.py::test_digital_roundtrip_qpsk for each
    constellation: map, decide, recover the symbols; the mapped points
    equal the reference's."""
    def const(mod):
        C = mod.Constellation
        return C.psk(8, 0.1) if name == "psk8" else getattr(C, name)()

    m = len(const(tdig).points)
    syms = np.random.default_rng(0).integers(0, m, 4096).astype(np.int32)
    got = _graph("torch", [tdig.chunks_to_symbols(const(tdig)),
                           tdig.constellation_decoder(const(tdig))],
                 syms, "ri32", "ri32", 1024)
    np.testing.assert_array_equal(got, syms)
    pts = _graph("torch", [tdig.chunks_to_symbols(const(tdig))], syms, "ri32",
                 "cf32", 1024)
    ref = _graph("jax", [jdig.chunks_to_symbols(const(jdig))], syms, "ri32",
                 "cf32", 1024)
    np.testing.assert_array_equal(pts, ref)


def test_constellation_decide_matches_reference_on_noise():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    for name in ("bpsk", "qpsk", "qam16"):
        got = getattr(tdig.Constellation, name)().decide(torch.from_numpy(x))
        ref = getattr(jdig.Constellation, name)().decide(jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="power of 2"):
        tdig.Constellation([1, 2, 3])


@pytest.mark.parametrize("modulus", [4, 5])
def test_digital_diff_codec(modulus):
    """Twin of tests/test_aux.py::test_digital_diff_codec: the codec
    recovers its input; the encoder's stream equals the reference's (the
    int32 cumsum and the floor modulus, also for a modulus that does not
    divide 2^32)."""
    syms = np.random.default_rng(1).integers(0, modulus, 2048).astype(np.int32)
    got = _graph("torch", [tdig.diff_encoder(modulus), tdig.diff_decoder(modulus)],
                 syms, "ri32", "ri32", 512)
    np.testing.assert_array_equal(got, syms)
    enc = _graph("torch", [tdig.diff_encoder(modulus)], syms, "ri32", "ri32", 512)
    ref = _graph("jax", [jdig.diff_encoder(modulus)], syms, "ri32", "ri32", 512)
    np.testing.assert_array_equal(enc, ref)


def test_binary_slicer():
    x = np.random.default_rng(3).standard_normal(1024).astype(np.float32)
    x[:2] = [0.0, -0.0]
    got = _graph("torch", [tdig.binary_slicer()], x, "rf32", "ri32", 256)
    ref = _graph("jax", [jdig.binary_slicer()], x, "rf32", "ri32", 256)
    np.testing.assert_array_equal(got, ref)


def test_loop_blocks_match_reference_and_take_parameter_changes():
    """costas_loop and clock_recovery_mm blocks in graphs, 4 batches:
    within 1e-4 of the reference's graphs; their gains are parameters (a
    changed loop_bw changes the output, as in the reference)."""
    x = _rrc_stream(4, 8192, seed=9, streams=(1,))[0]

    def run(pkg, bw):
        dig = jdig if pkg == "jax" else tdig
        return _graph(pkg, [dig.clock_recovery_mm(4, gain_mu=0.1),
                            dig.costas_loop(bw, order=4)], x, "cf32", "cf32",
                      2048)

    got, ref = run("torch", 0.06), run("jax", 0.06)
    assert got.shape == (2048,)
    _close(ref, got, "loop blocks")
    wide = run("torch", 0.2)
    _close(run("jax", 0.2), wide, "loop blocks at loop_bw 0.2")
    assert not np.array_equal(wide, got)
