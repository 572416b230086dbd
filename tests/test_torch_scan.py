"""S4 (iir_filter) and S5 (agc), the port's hand kernels for the
reference's two ``lax.associative_scan``s (csrc/scan.cu,
ops/cuda/scan.py). The kernels run only on the card (chip_smoke.py phase
64); here their plain versions are held against the JAX package and scipy
float64 over the orders, dtypes, feed-forward lengths and batch lengths
the kernels take, S4's host-built constants against numpy's matrix
powers, and a numpy model of each kernel's decomposition (segments, the
block's scan, the fixed partition of the tiles before a tile, the rerun)
against the plain versions."""

import re

import numpy as np
import pytest
import scipy.signal as sig
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.ops import agc as jagc, iir as jiir

from newsched_tpu_torch import testing
from newsched_tpu_torch.ops import agc, iir
from newsched_tpu_torch.ops.cuda import _build, launch_counters, scan as kscan

snr_db = testing.snr_db
# the reference's functions compiled once a shape (eagerly, its scans take
# seconds a call on the CPU); max_gain static, as the reference tests it
# against a Python number
JIIR = jax.jit(jiir.iir_filter)
JAGC = jax.jit(jagc.agc, static_argnums=(4,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _filter(order: int):
    """(b, a) in float64 of a stable filter of the order: config #1's
    de-emphasis pole at 1, Butterworths at 2-4, eight pole pairs at
    radius 0.6-0.8 at 16."""
    if order == 1:
        return np.array([0.235]), np.array([1.0, -0.765])
    if order in (2, 3, 4):
        return sig.butter(order, {2: 0.3, 3: 0.1, 4: 0.2}[order])
    r = np.linspace(0.6, 0.8, 8)
    th = np.linspace(0.2, 2.9, 8)
    poles = np.concatenate([r * np.exp(1j * th), r * np.exp(-1j * th)])
    return np.ones(1), np.real(np.poly(poles))


def _taps(order: int, nff: int):
    """(ff, fb) float32: the order's feedback taps, nff seeded feed-forward
    taps (the filter's own b where it has nff of them)."""
    b, a = _filter(order)
    ff, fb = iir.lfilter_taps(b, a)
    if len(ff) != nff:
        ff = (np.random.default_rng(nff).standard_normal(nff) / nff
              ).astype(np.float32)
    return ff, fb


def _signal(n: int, cplx: bool, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if cplx:
        x = x + 1j * rng.standard_normal(n)
    return x.astype(np.complex64 if cplx else np.float32)


def _stream(pkg, ff, fb, x, sizes):
    """x through iir_filter in batches of the given sizes, the state
    carried: the JAX package's or the port's plain version."""
    outs, i = [], 0
    if pkg == "jax":
        s = jiir.iir_init_state(len(ff), len(fb), dtype=jnp.asarray(x).dtype)
    else:
        s = iir.iir_init_state(len(ff), len(fb), "cpu",
                               torch.from_numpy(x).dtype)
    for b in sizes:
        if pkg == "jax":
            s, y = JIIR(jnp.asarray(ff), jnp.asarray(fb), s,
                        jnp.asarray(x[i:i + b]))
        else:
            s, y = iir.iir_filter(ff, fb, s, torch.from_numpy(x[i:i + b]))
        outs.append(np.asarray(y))
        i += b
    return np.concatenate(outs), s


# batches no multiple of any tile, the first shorter than orders 4 and 16
SIZES = (3, 2500, 1111)


@pytest.mark.parametrize("nff", [1, 2, 5, 33])
@pytest.mark.parametrize("dtype", ["rf32", "cf32"])
@pytest.mark.parametrize("order", [1, 2, 4, 16])
def test_iir_plain_matches_reference_and_scipy(order, dtype, nff):
    """The plain version (S4's) streamed in batches of 3, 2500 and 1111
    (the first shorter than the order at 4 and 16): >= 100 dB against the
    reference's associative scan and > 80 dB against scipy float64 with
    the same float32 taps; 33 feed-forward taps cross S4's 32-tap split.
    The new state's history is the last outputs, in the reference's
    layout."""
    ff, fb = _taps(order, nff)
    x = _signal(sum(SIZES), dtype == "cf32", seed=10 * order + nff)
    got, st = _stream("torch", ff, fb, x, SIZES)
    ref, jst = _stream("jax", ff, fb, x, SIZES)
    gold = sig.lfilter(ff.astype(np.float64),
                       np.concatenate([[1.0], -fb.astype(np.float64)]),
                       x.astype(np.complex128 if dtype == "cf32"
                                else np.float64))
    assert got.dtype == x.dtype
    assert snr_db(gold, got) > 80
    assert snr_db(ref, got) >= 100
    np.testing.assert_array_equal(st.y_hist.numpy(), got[::-1][:order])
    np.testing.assert_array_equal(np.asarray(jst.y_hist).shape, (order,))


@pytest.mark.parametrize("order", [1, 2, 4, 5, 16])
def test_s4_power_tables_are_numpys_matrix_powers(order):
    """S4's host constants against numpy.linalg.matrix_power in float64:
    pows[k] = A^(SEG 2^k), k < POWS, and dist[m] = A^(TILE m) for every
    distance between a batch's tiles, A the companion matrix (the taps
    padded to the instance's width); orders 5-16 run the 16 instance."""
    fb = np.float32([0.5, -0.2, 0.1, -0.05, 0.02]) if order == 5 \
        else _taps(order, 1)[1]
    P = kscan.state_width(order)
    assert P == (order if order <= 4 else 16)
    A = kscan.companion(fb, P)
    assert A.shape == (P, P) and np.all(A[0, :order] == fb)
    pows = kscan.powers_table(fb)
    assert pows.shape == (kscan.POWS, P, P)
    for k in range(kscan.POWS):
        np.testing.assert_allclose(
            pows[k], np.linalg.matrix_power(A, kscan.SEG << k), rtol=1e-9,
            atol=1e-15)
    for n in (1, kscan.TILE, kscan.TILE + 1, 104448, 1 << 20):
        dist = kscan.distance_table(fb, n)
        assert dist.shape == (kscan.n_tiles(n), P, P)
        for m in sorted({0, len(dist) // 2, len(dist) - 1}):
            want = np.linalg.matrix_power(A, kscan.TILE * m)
            np.testing.assert_allclose(dist[m], want, rtol=1e-9,
                                       atol=1e-12 * max(1.0, np.abs(want).max()))


def test_s4_refuses_past_order_16_naming_r3():
    """Past order 16 S4's constants refuse before touching a device, and
    the message names ROADMAP Queue 3's R3; complex taps are refused too."""
    fb = np.zeros(17, np.float32)
    with pytest.raises(ValueError, match="R3"):
        kscan.state_width(17)
    with pytest.raises(ValueError, match="R3"):
        iir.iir_consts(np.ones(2, np.float32), fb, 1000, "cuda")
    with pytest.raises(ValueError, match="real taps"):
        kscan.scan_consts(np.ones(2, np.complex64), fb[:2], 1000, "cuda")
    assert [kscan.state_width(o) for o in (0, 1, 4, 5, 16)] == [1, 1, 4, 16, 16]


def test_scan_constants_mirror_the_source():
    """ops/cuda/scan.py's tile geometry is csrc/scan.cu's, and both
    launchers are bound."""
    text = (_build.CSRC / "scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kThreads") == kscan.THREADS
    assert const("kSeg") == kscan.SEG
    assert const("kPows") == kscan.POWS
    assert const("kGroup") == kscan.GROUP
    assert const("kHalo") == kscan.MAX_FF
    assert const("kMaxP") == kscan.MAX_ORDER
    for fn in ("iir_scan_launch", "agc_scan_launch"):
        assert f'extern "C" int {fn}(' in text and fn in _build.SIGNATURES
    names = {(f.__name__, a) for f, a in launch_counters()}
    assert {("iir_scan", "launches"), ("agc_scan", "launches")} <= names


def test_scansplit_cuts_find_their_anchors():
    """``probes/stages.py scansplit`` cuts csrc/scan.cu at anchors that must
    each be there once, after the cuts before them."""
    from newsched_tpu_torch.probes import stages

    text = (_build.CSRC / "scan.cu").read_text()
    for _, cuts in stages._SCAN_CUTS:
        for a, b in cuts:
            assert text.count(a) == 1, a
            text = text.replace(a, b)


def test_wrappers_refuse_cpu_tensors_and_the_ops_take_the_plain_versions():
    """The kernels' wrappers raise on a CPU tensor; iir_filter and agc on a
    CPU tensor run the plain versions and launch nothing."""
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="CUDA"):
        kscan.agc_scan(x, torch.tensor(1.0), 0.1, 1.0)
    c = kscan.scan_consts([1.0], [0.5], 10, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kscan.iir_scan(x, x[:0], torch.zeros(1), c)
    n0 = (kscan.iir_scan.launches, kscan.agc_scan.launches)
    iir.iir_filter([1.0], [0.5], iir.iir_init_state(1, 1, "cpu"), x)
    agc.agc(agc.agc_init_state(1.0, "cpu"), x, 0.1, 1.0)
    assert (kscan.iir_scan.launches, kscan.agc_scan.launches) == n0


# -- a numpy model of the kernels' decomposition ------------------------------

T, S = kscan.TILE, kscan.SEG
W = kscan.THREADS // 32      # warps a block
F = np.float32


def _mv(M, v):
    """M v for a (P, P) M and vectors along the last axis of v."""
    return (v @ M.T).astype(F)


def s4_model(x, ff, fb, tail, hist):
    """csrc/scan.cu's S4 on one real stream, in float32, in its order of
    stages: v from the FIR over [tail, x]; each thread's segment from a
    zero state; each warp's scan by pows[k] (shfl_up by 2^k); the tile's
    aggregate from the warps' totals by A^(32 SEG); a group's aggregate
    from its GROUP tiles', lane l taking two; each tile's start from
    dist[tile] h, the groups g = l, l + 32, ... before its own through
    dist[tile - GROUP (g + 1)] and its group's tiles first + l and first +
    32 + l through dist[tile - 1 - j], lane l's terms summed and the lanes
    summed in a butterfly; each warp's
    start, each thread's (A^(SEG lane) times its warp's plus the warp's
    exclusive state), and the rerun. Returns (y, new tail, new history)."""
    n, nff, order = len(x), len(ff), len(fb)
    P = kscan.state_width(order)
    fbp = np.zeros(P, F)
    fbp[:order] = fb
    pows = kscan.powers_table(fbp).astype(F)
    dist = kscan.distance_table(fbp, n).astype(F)
    nt = kscan.n_tiles(n)
    xfull = np.concatenate([tail, x, np.zeros(nt * T - n, F)]).astype(F)
    v = np.zeros(nt * T, F)
    for k in range(nff):
        v = (v + F(ff[k]) * xfull[nff - 1 - k: nff - 1 - k + nt * T]).astype(F)
    v = v.reshape(nt, W, 32, S)

    def step(z, vj):
        y = (vj + z @ fbp).astype(F)
        return np.concatenate([y[..., None], z[..., :-1]], -1), y

    z = np.zeros((nt, W, 32, P), F)
    for j in range(S):
        z, _ = step(z, v[..., j])
    for k in range(5):  # a warp's scan
        d = 1 << k
        z[:, :, d:] = z[:, :, d:] + _mv(pows[k], z[:, :, :-d])
    e = np.zeros_like(z)
    e[:, :, 1:] = z[:, :, :-1]
    tot = z[:, :, 31]                                   # (nt, W, P)
    agg = tot[:, 0]
    for w in range(1, W):
        agg = _mv(pows[5], agg) + tot[:, w]
    h = np.zeros(P, F)
    h[:order] = hist
    G = kscan.GROUP

    def butterfly(lanes):
        lanes = np.stack(lanes)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ o]
        return lanes[0]

    # a group's aggregate, by its last tile: lane l's tiles first + l and
    # first + 32 + l through G - 1 - l and 31 - l tiles
    gagg = {g: butterfly([_mv(dist[G - 1 - lane], agg[G * g + lane])
                          + _mv(dist[31 - lane], agg[G * g + 32 + lane])
                          for lane in range(32)])
            for g in range(nt // G) if G * g + G - 1 < nt - 1}
    start = np.zeros((nt, P), F)
    for tile in range(nt):
        grp, first = tile // G, tile // G * G
        lanes = []
        for lane in range(32):
            acc = _mv(dist[tile], h) if lane == 0 else np.zeros(P, F)
            for g in range(lane, grp, 32):
                acc = acc + _mv(dist[tile - G * (g + 1)], gagg[g])
            for j in (first + lane, first + 32 + lane):
                if j < tile:
                    acc = acc + _mv(dist[tile - 1 - j], agg[j])
            lanes.append(acc)
        start[tile] = butterfly(lanes)
    ws = np.zeros((nt, W, P), F)
    acc = start
    for w in range(W):
        ws[:, w] = acc
        acc = _mv(pows[5], acc) + tot[:, w]
    st = np.repeat(ws[:, :, None], 32, 2)
    lane = np.arange(32)
    for k in range(5):
        m = (lane >> k & 1).astype(bool)
        st[:, :, m] = _mv(pows[k], st[:, :, m])
    st = st + e
    y = np.zeros((nt, W, 32, S), F)
    states = np.zeros((nt, W, 32, S, P), F)
    for j in range(S):
        st, y[..., j] = step(st, v[..., j])
        states[..., j, :] = st
    new_hist = states.reshape(-1, P)[n - 1, :order]
    return y.reshape(-1)[:n], xfull[n:n + nff - 1], new_hist


def _compose(m2, m1):
    """m2 o m1 for affine maps (A, B): g -> A2 (A1 g + B1) + B2."""
    return m2[0] * m1[0], m2[0] * m1[1] + m2[1]


def s5_model(x, g0, rate, ref, max_gain):
    """csrc/scan.cu's S5 in float32 in its order of stages: each thread's
    map, each warp's scan, the tile's aggregate from its warps' totals, a
    group's map from its GROUP tiles', each tile's start gain from the
    groups' maps before its own (lane l's contiguous groups [l q, (l + 1)
    q)) on the carried gain, then its group's tiles' before it (lane l's
    two), each warp's start gain, and the rerun. Returns (y, new gain)."""
    n = len(x)
    nt = kscan.n_tiles(n)
    mag = np.abs(x).astype(F)
    a = (F(1) - F(rate) * mag).astype(F)
    b = F(rate) * F(ref)
    a = np.concatenate([a, np.ones(nt * T - n, F)]).reshape(nt, W, 32, S)
    bb = np.concatenate([np.full(n, b, F), np.zeros(nt * T - n, F)]
                        ).reshape(nt, W, 32, S)
    A = np.ones((nt, W, 32), F)
    B = np.zeros((nt, W, 32), F)
    for j in range(S):
        A, B = _compose((a[..., j], bb[..., j]), (A, B))
    for k in range(5):
        d = 1 << k
        A2, B2 = _compose((A[:, :, d:], B[:, :, d:]),
                          (A[:, :, :-d], B[:, :, :-d]))
        A[:, :, d:], B[:, :, d:] = A2, B2
    eA, eB = np.ones_like(A), np.zeros_like(B)
    eA[:, :, 1:], eB[:, :, 1:] = A[:, :, :-1], B[:, :, :-1]
    tA, tB = A[:, :, 31], B[:, :, 31]
    aggA, aggB = tA[:, 0], tB[:, 0]
    for w in range(1, W):
        aggA, aggB = _compose((tA[:, w], tB[:, w]), (aggA, aggB))
    G = kscan.GROUP

    def in_order(maps):
        total = (F(1), F(0))
        for m in maps:
            total = _compose(m, total)
        return total

    gmap = {g: in_order([(aggA[j], aggB[j]) for j in range(G * g, G * g + G)])
            for g in range(nt // G) if G * g + G - 1 < nt - 1}
    gt = np.zeros(nt, F)
    for tile in range(nt):
        grp, first = tile // G, tile // G * G
        q = -(-grp // 32)
        gm = [in_order([gmap[g] for g in range(min(lane * q, grp),
                                                min(lane * q + q, grp))])
              for lane in range(32)]
        tm = in_order([(aggA[j], aggB[j]) for j in range(first, tile)])
        gA, gB = in_order(gm)
        gt[tile] = tm[0] * (gA * F(g0) + gB) + tm[1]
    gw = np.zeros((nt, W), F)
    g = gt
    for w in range(W):
        gw[:, w] = g
        g = tA[:, w] * g + tB[:, w]
    g = eA * gw[:, :, None] + eB
    gains = np.zeros((nt, W, 32, S), F)
    for j in range(S):
        gains[..., j] = g
        g = a[..., j] * g + bb[..., j]
    gains = gains.reshape(-1)[:n]
    gain = F(a.reshape(-1)[n - 1] * gains[-1] + b)
    if max_gain > 0:
        gains, gain = np.minimum(gains, F(max_gain)), min(gain, F(max_gain))
    return (x * gains).astype(x.dtype), gain


@pytest.mark.parametrize("order,nff,cplx,tiles", [
    (1, 2, False, 70), (4, 5, False, 70), (16, 5, True, 70),
    (3, 33, False, 70), (1, 2, False, 2200)])
def test_s4_model_matches_the_plain_version(order, nff, cplx, tiles):
    """The model of S4's decomposition over 70 tiles and a ragged end (a
    group of 64 and a part), and over 2200 (lanes take two groups), from
    a nonzero state: >= 100 dB against the plain version; the new history
    its last outputs, the new FIR history the input's last samples. At 33
    taps the wrapper hands S4 v with one unit tap."""
    ff, fb = _taps(order, nff)
    n = (tiles - 1) * T + 123
    x = _signal(n, cplx, seed=order + 100)
    tail = _signal(nff - 1, cplx, seed=order + 200)
    hist = _signal(order, cplx, seed=order + 300)
    st = iir.IirState(fir=iir.fir_ops.FirState(torch.from_numpy(tail)),
                      y_hist=torch.from_numpy(hist))
    new, want = iir.iir_filter(ff, fb, st, torch.from_numpy(x))
    parts = [x.real, x.imag] if cplx else [x]
    tails = [tail.real, tail.imag] if cplx else [tail]
    hists = [hist.real, hist.imag] if cplx else [hist]
    outs = []
    for xp, tp, hp in zip(parts, tails, hists):
        if nff > kscan.MAX_FF:
            vfull = sig.lfilter(ff, [1.0], np.concatenate([tp, xp]))
            xp, tp, ffk = vfull[nff - 1:].astype(F), np.zeros(0, F), [1.0]
        else:
            ffk = ff
        outs.append(s4_model(xp.astype(F), ffk, fb, tp.astype(F),
                             hp.astype(F)))
    y = outs[0][0] + 1j * outs[1][0] if cplx else outs[0][0]
    h = outs[0][2] + 1j * outs[1][2] if cplx else outs[0][2]
    assert snr_db(want.numpy(), y) >= 100
    # [0] the last output; the older entries of a segment's state come
    # from its start state, the outputs before it within rounding
    assert h[0] == y[-1]
    np.testing.assert_allclose(h, y[::-1][:order], rtol=1e-5,
                               atol=1e-6 * np.abs(y).max())
    if nff <= kscan.MAX_FF:
        t_new = outs[0][1] + 1j * outs[1][1] if cplx else outs[0][1]
        np.testing.assert_array_equal(new.fir.tail.numpy(), t_new)


@pytest.mark.parametrize("n,max_gain", [(1 << 17, 0.0), (70 * T + 5, 1.2),
                                        (3, 0.0), (2200 * T - 9, 0.0)])
def test_s5_model_matches_the_plain_version(n, max_gain):
    """The model of S5's decomposition (64, 70 and 2200 tiles, where lanes
    take two groups, and a 3-sample batch): >= 100 dB against the plain
    version, the new gain within 1e-5, the clamp applied after the
    scan."""
    x = (0.3 * _signal(n, True, seed=n)).astype(np.complex64)
    y, g = s5_model(x, 1.3, 0.01, 1.0, max_gain)
    st, want = agc.agc(agc.AgcState(torch.tensor(1.3)), torch.from_numpy(x),
                       0.01, 1.0, max_gain)
    assert snr_db(want.numpy(), y) >= 100
    assert float(st.gain) == pytest.approx(float(g), rel=1e-5)


@pytest.mark.parametrize("dtype", ["cf32", "rf32"])
@pytest.mark.parametrize("max_gain", [0.0, 1.5])
def test_agc_plain_with_tensor_parameters_matches_reference(dtype, max_gain):
    """S5's plain version with rate and reference as 0-dim tensors (the
    block's settable parameters), with and without max_gain, streamed in
    batches no multiple of a tile (3, 2049, 5000): >= 100 dB against the
    reference's scan, the carried gain as the reference's."""
    n = 3 + 2049 + 5000
    x = 0.2 * _signal(n, dtype == "cf32", seed=5)
    s, js = agc.agc_init_state(1.0, "cpu"), jagc.agc_init_state(1.0)
    rate, ref = torch.tensor(2e-3), torch.tensor(0.8)
    outs, jouts, i = [], [], 0
    for b in (3, 2049, 5000):
        s, y = agc.agc(s, torch.from_numpy(x[i:i + b]), rate, ref, max_gain)
        js, jy = JAGC(js, jnp.asarray(x[i:i + b]), 2e-3, 0.8, max_gain)
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
        i += b
    assert snr_db(np.concatenate(jouts), np.concatenate(outs)) >= 100
    assert float(s.gain) == pytest.approx(float(js.gain), rel=1e-5)
    if max_gain > 0:
        assert float(s.gain) <= max_gain
