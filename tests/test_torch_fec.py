"""The port's FEC (ops/fec.py: the convolutional encoder, S3 viterbi_decode
and its plain version on the CPU, the interleavers; blocks/fec.py) held
against the JAX package on the same numpy inputs: bit-equal for the
(171/133, K = 7) and (7/5, K = 3) codes, hard and soft; the reference's
own cases mirrored (tests/test_fec.py); the tie-break on an input built to
tie; the encoder -> LLR -> decoder graph at frame 128; a 16384-bit frame,
a rate-1/5 and a K = 12 code (S3's device-memory routes); a K = 16 code,
whose metrics S3 keeps in device memory, and its plan past K = 15."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from newsched_tpu.ops import fec as jf

from newsched_tpu_torch.blocks import fec as tfecb, general as tgen
from newsched_tpu_torch.ops import fec as tf
from newsched_tpu_torch.ops.cuda import _build, fec as kfec
from newsched_tpu_torch.runtime.blockspec import block_from_yaml
from newsched_tpu_torch.runtime.graph import Flowgraph

CODES = [(jf.CC_K7_POLYS, 7), ((0o7, 0o5), 3)]


def _np_conv_encode(bits, polys, K):
    """Independent shift-register reference encoder (tests/test_fec.py's)."""
    out = []
    state = 0
    for b in list(bits) + [0] * (K - 1):
        state = ((state << 1) | int(b)) & ((1 << K) - 1)
        for p in polys:
            out.append(bin(state & p).count("1") & 1)
    return np.array(out, dtype=np.int32)


@pytest.mark.parametrize("polys,K", CODES)
def test_conv_encode_matches_reference(polys, K):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 200))
    got = tf.conv_encode(torch.from_numpy(bits), polys, K)
    assert got.dtype == torch.int32 and got.shape == (3, (200 + K - 1) * 2)
    for f in range(3):
        ref = np.asarray(jf.conv_encode(jnp.asarray(bits[f]), polys, K))
        np.testing.assert_array_equal(got[f].numpy(), ref)
        np.testing.assert_array_equal(ref, _np_conv_encode(bits[f], polys, K))
    unterminated = tf.conv_encode(torch.from_numpy(bits[0]), polys, K,
                                  terminate=False)
    np.testing.assert_array_equal(
        unterminated.numpy(),
        np.asarray(jf.conv_encode(jnp.asarray(bits[0]), polys, K, terminate=False)))


def test_trellis_tables_are_the_references():
    for polys, K in CODES:
        np.testing.assert_array_equal(tf._poly_bits(polys, K),
                                      jf._poly_bits(polys, K))
        for a, b in zip(tf._trellis(polys, K), jf._trellis(polys, K)):
            np.testing.assert_array_equal(a, b)
        pred, pbit, psym = tf.viterbi_tables(polys, K, "cpu")
        S = 1 << (K - 1)
        assert pred.dtype == torch.int32 and psym.shape == (S, 2, len(polys))
        assert set(pred[:, 0].tolist()) | set(pred[:, 1].tolist()) == set(range(S))


def _frames(polys, K, n_frames, n_bits, sigma, seed, hard=False):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, n_bits))
    coded = tf.conv_encode(torch.from_numpy(bits), polys, K).numpy()
    tx = 2.0 * coded - 1.0
    rx = tx + rng.normal(0, sigma, tx.shape)
    llr = np.where(rx > 0, 1.0, -1.0) if hard else rx
    return bits, llr.astype(np.float32)


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("kind", ["hard", "soft"])
@pytest.mark.parametrize("polys,K", CODES)
def test_viterbi_matches_reference(polys, K, kind, terminated):
    """Four noisy frames at once against the reference frame by frame: the
    decoded bits bit-equal (hard +-1 LLRs tie often: the tie-break is the
    reference's)."""
    _, llr = _frames(polys, K, 4, 256, 0.8, seed=K, hard=kind == "hard")
    got = tf.viterbi_decode(torch.from_numpy(llr), polys, K,
                            terminated=terminated)
    for f in range(4):
        ref = np.asarray(jf.viterbi_decode(jnp.asarray(llr[f]), polys, K,
                                           terminated=terminated))
        np.testing.assert_array_equal(got[f].numpy(), ref)
    one = tf.viterbi_decode(torch.from_numpy(llr[0]), polys, K,
                            terminated=terminated)
    assert one.shape == got[0].shape and torch.equal(one, got[0])


def test_viterbi_tie_break_is_the_references():
    """LLRs built to tie: all zero (every comparison ties, so predecessor 0
    everywhere) and +-1 with every other coded pair erased to 0: the bits
    bit-equal to the reference's."""
    polys, K = jf.CC_K7_POLYS, 7
    zero = np.zeros(2 * 70, np.float32)
    got = tf.viterbi_decode(torch.from_numpy(zero), polys, K, terminated=False)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jf.viterbi_decode(jnp.asarray(zero), polys, K,
                                                  terminated=False)))
    _, llr = _frames(polys, K, 1, 128, 0.0, seed=4, hard=True)
    llr = llr[0].reshape(-1, 2)
    llr[::2] = 0.0
    llr = llr.reshape(-1)
    for term in (True, False):
        got = tf.viterbi_decode(torch.from_numpy(llr), polys, K, terminated=term)
        ref = jf.viterbi_decode(jnp.asarray(llr), polys, K, terminated=term)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("polys,K", CODES)
def test_viterbi_noiseless(polys, K):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 300)
    coded = tf.conv_encode(torch.from_numpy(bits), polys, K)
    dec = tf.viterbi_decode(tf.hard_to_llr(coded), polys, K)
    np.testing.assert_array_equal(dec.numpy(), bits)


def test_viterbi_corrects_errors():
    """K=7 rate-1/2 has free distance 10: four flipped coded bits, well
    separated, are corrected (tests/test_fec.py:41)."""
    bits = np.random.default_rng(2).integers(0, 2, 256)
    coded = tf.conv_encode(torch.from_numpy(bits)).numpy()
    for pos in (17, 150, 301, 450):
        coded[pos] ^= 1
    dec = tf.viterbi_decode(tf.hard_to_llr(torch.from_numpy(coded)))
    np.testing.assert_array_equal(dec.numpy(), bits)


def test_viterbi_soft_beats_hard():
    """At ~3.7 dB Eb/N0 (sigma 0.65) the soft decoder's BER is under a
    fifth of the raw BER (tests/test_fec.py:54)."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 512)
    coded = tf.conv_encode(torch.from_numpy(bits)).numpy().astype(np.float64)
    tx = 2 * coded - 1
    noisy = tx + rng.normal(0, 0.65, tx.shape)
    assert np.any((noisy > 0) != (tx > 0))
    dec = tf.viterbi_decode(torch.from_numpy(noisy.astype(np.float32))).numpy()
    ber = np.mean(dec != bits)
    raw_ber = np.mean((noisy > 0).astype(int) != coded.astype(int))
    assert raw_ber > 0.02
    assert ber < raw_ber / 5, (ber, raw_ber)
    hard = tf.viterbi_decode(tf.hard_to_llr(torch.from_numpy(
        (noisy > 0).astype(np.int32)))).numpy()
    assert ber <= np.mean(hard != bits)


def test_interleave_roundtrip():
    x = np.random.default_rng(4).standard_normal(96).astype(np.float32)
    il = tf.block_interleave(torch.from_numpy(x), rows=8)
    np.testing.assert_array_equal(
        il.numpy(), np.asarray(jf.block_interleave(jnp.asarray(x), rows=8)))
    back = tf.block_deinterleave(il, rows=8)
    np.testing.assert_array_equal(back.numpy(), x)
    assert not np.array_equal(il.numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        tf.block_interleave(torch.from_numpy(x), rows=7)


# ri16 hard bits -> rf32 +-1 LLRs, from a descriptor as the reference's test
# builds it (tests/test_fec.py::test_fec_graph_end_to_end), in torch
_bits_to_llr = block_from_yaml("""
module: fec
block: bits_to_llr
label: Hard bits to LLR
ports:
  - {domain: stream, id: in,  direction: input,  type: ri16}
  - {domain: stream, id: out, direction: output, type: rf32}
expr: "2.0 * in_.to(torch.float32) - 1.0"
""")


@pytest.mark.parametrize("interleave", [False, True])
def test_fec_graph_end_to_end(interleave):
    """vector_source(bits) -> cc_encoder -> (to LLR) -> [interleaver ->
    deinterleaver] -> cc_decoder -> sink through the compiled graph at frame
    128 (the rate algebra's (frame+K-1)*n/frame ratio)."""
    frame = 128
    bits = np.random.default_rng(5).integers(0, 2, 4 * frame).astype(np.int16)
    fg = Flowgraph(batch_size=2 * frame)
    chain = [tgen.vector_source(bits, dtype="ri16"),
             tfecb.cc_encoder(frame_bits=frame), _bits_to_llr()]
    if interleave:
        coded = (frame + 6) * 2
        chain += [tfecb.interleaver(coded, 4), tfecb.deinterleaver(coded, 4)]
    snk = tgen.vector_sink(dtype="ri16")
    chain += [tfecb.cc_decoder(frame_bits=frame), snk]
    for a, b in zip(chain, chain[1:]):
        fg.connect(a, 0, b, 0)
    fg.run(device="cpu")
    assert snk.data().dtype == np.int16
    np.testing.assert_array_equal(snk.data(), bits)


def test_viterbi_refuses_codes_the_kernel_cannot_take(monkeypatch):
    """On a device tensor (meta stands in for the card, with the H100's
    80 GiB) S3 refuses frames whose decision words (and the serial
    instance's metrics) pass the card's memory, naming the bytes: 600,000
    frames of 40 steps at K = 16 (98 GB of decision words; the cluster form
    keeps the metrics on chip); K = 16 on two frames (a cluster), K = 12,
    rate 1/5 and a frame past the block's shared memory go on to the build
    (their routes: the block or cluster instance, device memory); with
    `_build.build` failing each raises, never returning the plain
    result."""
    def no_build():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "build", no_build)
    meta = dict(device="meta", dtype=torch.float32)
    tabs16 = tf.viterbi_tables((0o152711, 0o126723), 16, "meta")
    with pytest.raises(ValueError, match=r"need \d+ B of device memory"):
        kfec.viterbi_frames(torch.empty(600000, 40, 2, **meta), tabs16, 16,
                            True)
    for llr, tabs, K in (
            (torch.empty(2, 40, 2, **meta), tabs16, 16),
            (torch.empty(2, 40, 2, **meta),
             tf.viterbi_tables((0o4037, 0o5741), 12, "meta"), 12),
            (torch.empty(2, 40, 5, **meta),
             tf.viterbi_tables((7, 5, 6, 3, 1), 3, "meta"), 3),
            (torch.empty(1, 1800, 2, **meta),
             tf.viterbi_tables((0o2565, 0o3753), 11, "meta"), 11)):
        with pytest.raises(_build.KernelBuildError):
            kfec.viterbi_frames(llr, tabs, K, True)
    with pytest.raises(_build.KernelBuildError):
        tf.viterbi_decode(torch.empty(3, 2 * 134, **meta))
    assert kfec.viterbi_frames.launches == 0


# The routes past the shared-memory frame: (code, K, bits a frame, the
# instance of one frame); each frame's LLRs and decision words pass a
# block's shared memory, so each plans the global-memory route (one frame
# at K = 12: a cluster of two blocks)
LONG = [(jf.CC_K7_POLYS, 7, 16384, "warp"),
        ((0o171, 0o133, 0o165, 0o117, 0o127), 7, 8192, "block"),
        ((0o4037, 0o5741), 12, 1024, "cluster")]


@pytest.mark.parametrize("polys,K,nbits,inst", LONG)
def test_viterbi_long_frames_and_codes_match_reference(polys, K, nbits, inst):
    """A 16384-bit frame at K = 7, a rate-1/5 code and a K = 12 code, soft
    and noisy: each plans the device-memory route of its instance, and the
    plain version's bits (what the kernel is held to on the card, phase
    51) equal the reference's bit for bit, terminated and not."""
    n = len(polys)
    _, llr = _frames(polys, K, 1, nbits, 0.8, seed=K + n)
    T = llr.shape[1] // n
    assert kfec.viterbi_plan(T, n, K) == (inst, "global")
    assert kfec.viterbi_smem(T, n, 1 << (K - 1), inst) > kfec.SMEM_MAX
    for terminated in (True, False):
        got = tf.viterbi_decode(torch.from_numpy(llr[0]), polys, K,
                                terminated=terminated)
        ref = np.asarray(jf.viterbi_decode(jnp.asarray(llr[0]), polys, K,
                                           terminated=terminated))
        np.testing.assert_array_equal(got.numpy(), ref)


# -- S3's warp instance, modelled lane by lane --------------------------------

def _keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving int keys of float32 values (its
    warp_max reduces these with one redux)."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def _warp_model(llr: torch.Tensor, tables, terminated: bool,
                nbits: int) -> torch.Tensor:
    """csrc/viterbi.cu's viterbi_warp_kernel in torch, every frame at once
    and lane by lane: lane l holds states l E .. l E + E - 1 (E = S/32; one
    state a lane below 32 states, lanes past S idle), reads its
    predecessors' metrics from lanes l>>1 and 16 + (l>>1) (l>>1 + S/2 at
    E = 1) as __shfl_sync does, picks its half of each source's E words by
    the parity of l, forms (m - g) + bm, packs each step's decisions into
    E ballot words (bit l of word e: state l E + e), takes the max by the
    int keys' redux, and traces back over the words alone: the state's
    word from its E, its bit l, the next state (s >> 1) + which S/2, the
    bit out s & 1."""
    F, T, n = llr.shape
    S = int(tables.pred.shape[0])
    E, H = max(1, S // 32), max(1, S // 64)
    lanes = torch.arange(32)
    live = lanes * E < S
    states = lanes[:, None] * E + torch.arange(E)                 # (32, E)
    sym = tables.psym[states.clamp(max=S - 1)]                    # (32, E, 2, n)
    v = torch.where(states == 0, 0.0, -1e9).to(torch.float32).expand(
        F, 32, E).clone()
    src0 = lanes >> 1
    src1 = (lanes >> 1) + (16 if E > 1 else S // 2)
    odd = (lanes & 1).bool()[None, :, None]
    pair = torch.arange(E) // 2
    g = torch.zeros(F, 1, 1)
    words = torch.zeros(T, F, E, dtype=torch.int64)
    weights = torch.tensor([1 << k for k in range(32)], dtype=torch.int64)
    neg_inf = torch.tensor(float("-inf"))

    def warp_max(x):  # (F, 32) -> (F, 1, 1)
        return _unkey(_keys(x).max(dim=1).values)[:, None, None]

    for t in range(T):
        a, b = v[:, src0], v[:, src1]                             # the shuffles
        if E > 1:
            a = torch.where(odd, a[..., H:], a[..., :H])
            b = torch.where(odd, b[..., H:], b[..., :H])
        m0, m1 = (a - g)[..., pair], (b - g)[..., pair]           # (F, 32, E)
        rt = llr[:, t]
        bm = sym[None, ..., 0] * rt[:, None, None, None, 0]
        for j in range(1, n):
            bm = bm + sym[None, ..., j] * rt[:, None, None, None, j]
        c0, c1 = m0 + bm[..., 0], m1 + bm[..., 1]
        ch = (c1 > c0) & live[None, :, None]
        v = torch.where(c1 > c0, c1, c0)
        words[t] = (ch.to(torch.int64) * weights[None, :, None]).sum(1)
        g = warp_max(torch.where(live, v.max(dim=2).values, neg_inf))
    if terminated:
        state = torch.zeros(F, dtype=torch.int64)
    else:
        fin = torch.where(live[None, :, None], v - g, neg_inf)
        best = fin.argmax(dim=2)                                  # the first max
        bv = fin.max(dim=2).values
        at = bv == warp_max(bv)[:, :, 0]
        win = at.to(torch.int64).argmax(dim=1)                    # __ffs - 1
        state = win * E + best.gather(1, win[:, None])[:, 0]
    out = torch.empty((F, T), dtype=torch.int32)
    for t in range(T - 1, -1, -1):
        word = words[t].gather(1, (state & (E - 1))[:, None])[:, 0]
        which = (word >> (state // E)) & 1
        out[:, t] = (state & 1).to(torch.int32)
        state = (state >> 1) + which * (S // 2)
    return out[:, :nbits]


WARP_CODES = [((0o7, 0o5), 3), ((0o23, 0o35), 5), (jf.CC_K7_POLYS, 7),
              ((0o561, 0o753), 9), ((0o2565, 0o3753), 11),
              ((0o171, 0o133, 0o165), 7)]


@pytest.mark.parametrize("kind", ["hard", "soft", "noiseless"])
@pytest.mark.parametrize("polys,K", WARP_CODES)
def test_warp_layout_model_is_the_plain_viterbi(polys, K, kind):
    """The warp instance's layout (states to lanes, shuffle sources, ballot
    words, the traceback over the words) modelled in torch: bit-equal to
    viterbi_frames_plain, terminated and not, at K = 3-11 (10 and 11 take
    the block instance on the card; the layout holds at any S), rate 1/2
    and 1/3."""
    tabs = tf.viterbi_tables(polys, K, "cpu")
    n = len(polys)
    for terminated in (True, False):
        bits, llr = _frames(polys, K, 3, 48, 0.0 if kind == "noiseless"
                            else 0.8, seed=K + n, hard=kind == "hard")
        if not terminated:
            coded = tf.conv_encode(torch.from_numpy(bits), polys, K,
                                   terminate=False).numpy()
            noise = np.random.default_rng(K).normal(0, 0.8, coded.shape)
            rx = 2.0 * coded - 1.0 + (0 if kind == "noiseless" else noise)
            llr = (np.where(rx > 0, 1.0, -1.0) if kind == "hard"
                   else rx).astype(np.float32)
        lt = torch.from_numpy(llr).reshape(3, -1, n)
        T = lt.shape[1]
        nbits = T - (K - 1) if terminated else T
        ref = kfec.viterbi_frames_plain(lt, tabs, terminated, nbits)
        got = _warp_model(lt, tabs, terminated, nbits)
        assert torch.equal(got, ref)
        if kind == "noiseless":
            np.testing.assert_array_equal(got.numpy(), bits[:, :nbits])


def test_warp_model_ties_like_the_plain_viterbi():
    """All-zero LLRs (every comparison ties) and +-1 with every other pair
    erased: the model's bits are the plain version's."""
    polys, K = jf.CC_K7_POLYS, 7
    tabs = tf.viterbi_tables(polys, K, "cpu")
    _, llr = _frames(polys, K, 2, 64, 0.0, seed=4, hard=True)
    llr = llr.reshape(2, -1, 2)
    llr[:, ::2] = 0.0
    for lt in (torch.zeros(2, 70, 2), torch.from_numpy(llr)):
        for terminated in (True, False):
            nbits = lt.shape[1] - (K - 1) if terminated else lt.shape[1]
            assert torch.equal(
                _warp_model(lt, tabs, terminated, nbits),
                kfec.viterbi_frames_plain(lt, tabs, terminated, nbits))


def test_viterbi_tables_assert_the_butterfly(monkeypatch):
    """The kernels read the predecessors from the butterfly, not from the
    tables: viterbi_tables checks that every code's tables are it, and
    raises on tables that are not (two predecessors swapped, a bit
    flipped)."""
    for K in range(2, 12):
        S = 1 << (K - 1)
        pred, pbit, _ = tf.viterbi_tables(((1 << (K - 1)) | 1, 3), K, "cpu")
        s = torch.arange(S, dtype=torch.int32)
        assert torch.equal(pred[:, 0], s >> 1)
        assert torch.equal(pred[:, 1], (s >> 1) + S // 2)
        assert torch.equal(pbit, torch.stack([s & 1, s & 1], 1))
    pred, pbit, psym = tf._tables_np(jf.CC_K7_POLYS, 7)
    for bad in (pred[:, ::-1].copy(), pbit):
        broken = (bad, pbit, psym) if bad is not pbit else (pred, 1 - pbit, psym)
        monkeypatch.setattr(tf, "_tables_np", lambda polys, K, b=broken: b)
        with pytest.raises(ValueError, match="butterfly"):
            tf.viterbi_tables(jf.CC_K7_POLYS, 7, "cpu")


def test_viterbi_instances_and_their_limits(monkeypatch):
    """K <= 9 at n <= 4 takes the warp instance, K = 10-18 and rate 1/5 at
    K >= 7 the block or cluster one, the rest the serial one; the warp
    instance's frame takes no more shared memory than the other instance
    of its code (so it stages every frame that one staged); a frame past
    the limit plans device memory (the warp frame at K = 7 past 14,528
    steps), and on a device tensor (meta) goes on to the build. The
    layouts at the routes' shapes: a block of 128 threads of 8 states at
    K = 11 x 1024 frames, 256 at K = 12 x 256 (the words in device memory:
    staged, 157 KB a block would leave one block an SM, two waves), one
    warp of 2 states a lane at rate 1/5 (staged); clusters of 8 blocks of
    16 states a thread at K = 15 x 32 and K = 16 x 16 frames (256 and 128
    blocks), of 4 at K = 16 past the card's SMs; every block within 227 KB
    and 512 threads, C <= 8."""
    assert [kfec.viterbi_instance(K) for K in (3, 7, 9, 10, 11, 12, 15)] == \
        ["warp"] * 3 + ["block"] * 4
    assert kfec.viterbi_instance(7, 5) == "block"
    assert kfec.viterbi_instance(5, 5) == kfec.viterbi_instance(12, 9) == \
        kfec.viterbi_instance(19) == "serial"
    for K in range(2, 10):
        S = 1 << (K - 1)
        other = "serial" if K < 7 else "block"
        for n in (1, 2, 4):
            for T in (1, 518, 4000):
                assert kfec.viterbi_smem(T, n, S, "warp") \
                    <= kfec.viterbi_smem(T, n, S, other)
    assert kfec.viterbi_smem(518, 2, 64, "warp") == 4 * 518 * (2 + 2)
    assert kfec.viterbi_plan(14528, 2, 7) == ("warp", "shared")
    assert kfec.viterbi_plan(14529, 2, 7) == ("warp", "global")
    L = kfec.viterbi_layout
    for (T, n, K, F), want in {
            (518, 2, 11, 1024): ("block", "global", 8, 1, 128),
            (523, 2, 12, 256): ("block", "global", 8, 1, 256),
            (518, 5, 7, 256): ("block", "shared", 2, 1, 32),
            (526, 4, 15, 32): ("cluster", "global", 16, 8, 128),
            (527, 2, 16, 16): ("cluster", "global", 16, 8, 256),
            (527, 2, 16, 1000): ("cluster", "global", 16, 4, 512),
            (525, 2, 14, 1000): ("cluster", "global", 16, 2, 256),
            (524, 2, 13, 1000): ("block", "global", 8, 1, 512),
            (529, 2, 18, 2): ("cluster", "global", 32, 8, 512)}.items():
        lay = L(T, n, K, F)
        assert lay[:5] == want, (T, n, K, F, lay)
        S = 1 << (K - 1)
        assert lay.threads * lay.E * lay.C == S and lay.C <= kfec.MAX_CLUSTER
        assert lay.smem == kfec.viterbi_smem(T, n, S, "block", lay.memory,
                                             lay.E, lay.C) <= kfec.SMEM_MAX
    # K = 12 at 256 frames: staging the words would cost a second wave
    staged = kfec.viterbi_smem(523, 2, 2048, "block", "shared", 8)
    assert staged == 4 * (2 * 2048 + 2 * 256 + 2 * 8 + kfec.ACS_AUX
                          + 523 * 2 + 523 * 64 + 523)
    assert kfec.SM_SMEM // (staged + 1024) == 1 and 256 > kfec.CARD_SMS
    glob = L(523, 2, 12, 256).smem
    assert kfec._waves(256, 1, 256, staged, 132) == 2
    assert kfec._waves(256, 1, 256, glob, 132) == 1
    assert L(523, 2, 10, 256)[:2] == ("block", "shared")  # 46 KB: one wave
    # the serial instance's codes at phase 51's routes: a block of S
    # threads (up to 1024) a frame, the metrics and the frame staged at 512
    # bits, in device memory past them
    for (T, n, K, F), want in {
            (516, 5, 5, 256): ("serial", "shared", 32),
            (518, 9, 7, 256): ("serial", "shared", 64),
            (523, 9, 12, 64): ("serial", "shared", 1024),
            (16388, 5, 5, 4): ("serial", "global", 32),
            (8198, 9, 7, 4): ("serial", "global", 64),
            (1035, 9, 12, 4): ("serial", "global", 1024)}.items():
        lay = L(T, n, K, F)
        assert (lay.instance, lay.memory, lay.threads) == want, (T, n, K)
        assert lay.smem == kfec.viterbi_smem(T, n, 1 << (K - 1), "serial",
                                             lay.memory) <= kfec.SMEM_MAX
    # K = 15 at one frame: a cluster; in one block its 2 x 16384 metrics
    assert kfec.viterbi_plan(518, 2, 15) == ("cluster", "global")
    assert kfec.viterbi_smem(518, 2, 1 << 14, "block", "global", 32) \
        == 4 * (2 * 16384 + 2 * 256 + 2 * 16 + kfec.ACS_AUX + 518 * 2) \
        <= kfec.SMEM_MAX
    with pytest.raises(ValueError, match="no block geometry"):
        kfec.acs_layout(518, 2, 15, 16, 1)  # 1024 threads
    assert kfec.viterbi_instance(16) == "block"

    def no_build():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "build", no_build)
    meta = dict(device="meta", dtype=torch.float32)
    tabs7 = tf.viterbi_tables(jf.CC_K7_POLYS, 7, "meta")
    with pytest.raises(_build.KernelBuildError):
        kfec.viterbi_frames(torch.empty(1, 15000, 2, **meta), tabs7, 7, True)
    assert kfec.viterbi_frames.launches == kfec.viterbi_frames.block_launches == 0


# -- S3's block and cluster instance, modelled block by block and lane by lane

def _swz(i: torch.Tensor, E: int) -> torch.Tensor:
    """csrc/viterbi.cu swz: a row's 16-byte groups swizzled past E = 4."""
    if E >= 8:
        return (((i >> 2) ^ ((i >> 5) & 7)) << 2) | (i & 3)
    return i


def _block_model(llr: torch.Tensor, tables, terminated: bool, nbits: int,
                 E: int, C: int) -> torch.Tensor:
    """The block (C = 1) and cluster instance's layout in torch: block r of
    a frame computes states r Sb .. (Sb = S/C), thread t the E states r Sb
    + t E + e, and keeps in two swizzled rows the metrics its own pairs
    read: the lo half p = r Sb/2 + t E/2 + h at t E/2 + h and the hi half p
    + S/2 at Sb/2 + t E/2 + h (at C = 1 its rows in state order); so the
    writer of state r Sb + i puts it into block 2 (r mod C/2) + (i >=
    Sb/2), into its lo half below C/2 and its hi half from it. Each branch
    metric is the LLRs with their sign bits flipped by psym's signs, summed
    in order; (m - g) + bm; each thread's E decisions one E-bit element of
    the step's words (natural: state s at bit s mod 32 of word s / 32); the
    max by int keys, a warp's table entry each, reduced over the frame's C
    P/32 entries; the argmax of the last step by (value, least state)
    thread, warp and block in turn; the traceback of one warp: lane l's
    word five steps ahead, of state (s >> 5) + l S/32, the path's lane
    picked by the five decisions between."""
    F, T, n = llr.shape
    S = int(tables.pred.shape[0])
    Sb, H, NW = S // C, E // 2, S // 32
    P = Sb // E
    neg = tables.psym < 0                                     # (S, 2, n)
    r = torch.arange(C)[:, None, None]
    t = torch.arange(P)[None, :, None]
    h = torch.arange(H)[None, None, :]
    lo, hi = _swz(t * H + h, E), _swz(Sb // 2 + t * H + h, E)  # (1, P, H)
    e_ = torch.arange(E)[None, None, :]
    states = r * Sb + t * E + e_                              # (C, P, E)
    sneg = neg[states]                                       # (C, P, E, 2, n)
    i = t * E + e_                                           # (1, P, E)
    if C == 1:
        dst = torch.zeros_like(states)
        off = i.expand_as(states)
    else:
        hb = (i >= Sb // 2).to(torch.int64)
        dst = 2 * (r % (C // 2)) + hb
        off = torch.where(r >= C // 2, Sb // 2, 0) + i - hb * (Sb // 2)
    dst, off = dst.reshape(-1), _swz(off.expand_as(states).reshape(-1), E)
    rows = torch.empty(F, C, 2, Sb)
    init = torch.full((C, Sb), -1e9)
    init[0, 0] = 0.0
    rows[:, :, 1, _swz(torch.arange(Sb), E)] = init
    g = torch.zeros(F, 1, 1, 1)
    words = torch.zeros(T, F, NW, dtype=torch.int64)
    per = 32 // E
    shifts = torch.tensor([i * E for i in range(per)], dtype=torch.int64)
    bitw = torch.tensor([1 << e for e in range(E)], dtype=torch.int64)
    for step in range(T):
        prev = rows[:, :, (step - 1) & 1]                     # (F, C, Sb)
        a, b = prev[:, :, lo[0]], prev[:, :, hi[0]]           # (F, C, P, H)
        m0 = (a - g).repeat_interleave(2, dim=-1)             # state 2h + u
        m1 = (b - g).repeat_interleave(2, dim=-1)
        rt = llr[:, step][:, None, None, None, :]             # (F,1,1,1,n)
        sgn = torch.where(sneg[None], -rt[..., None, :], rt[..., None, :])
        bm = sgn[..., 0]                                      # (F,C,P,E,2)
        for j in range(1, n):
            bm = bm + sgn[..., j]
        c0, c1 = m0 + bm[..., 0], m1 + bm[..., 1]
        ch = c1 > c0
        v = torch.where(ch, c1, c0)                           # (F, C, P, E)
        rows[:, dst, step & 1, off] = v.reshape(F, -1)        # the writers
        elem = (ch.to(torch.int64) * bitw).sum(-1).reshape(F, S // E)
        words[step] = (elem.reshape(F, NW, per) << shifts).sum(-1)
        wkeys = _keys(v.amax(-1)).reshape(F, C * P // 32, 32).amax(-1)
        g = _unkey(wkeys.amax(-1))[:, None, None, None]
    if terminated:
        state = torch.zeros(F, dtype=torch.int64)
    else:  # each block over its rows' offsets j, states by the two halves
        last = rows[:, :, (T - 1) & 1][..., _swz(torch.arange(Sb), E)]
        fe = (last - g[..., 0]).reshape(F, C, P, E)
        j = (t * E + e_).expand(C, P, E)
        st = torch.where(j < Sb // 2, 0, S // 2 - Sb // 2) + r * (Sb // 2) + j
        fe, st = fe.reshape(F, -1), st.reshape(-1).expand(F, -1)
        top = fe.max(dim=1, keepdim=True).values  # (value, least state)
        state = torch.where(fe == top, st, S).amin(dim=1)
    out = torch.empty((F, T), dtype=torch.int32)
    ring = torch.zeros(F, 5, 32, dtype=torch.int64)
    hist = torch.zeros(F, dtype=torch.int64)
    lane = torch.arange(32)
    for t0 in range(T - 1, -1, -5):
        for k in range(5):
            stp = t0 - k
            if stp < 0:
                break
            if stp >= T - 5:
                w = words[stp].gather(1, (state >> 5)[:, None])[:, 0]
            else:
                w = ring[:, k].gather(1, hist[:, None])[:, 0]
            if stp >= 5:
                ring[:, k] = words[stp - 5].gather(
                    1, ((state >> 5)[:, None] + lane * NW) >> 5)
            which = (w >> (state & 31)) & 1
            out[:, stp] = (state & 1).to(torch.int32)
            state = (state >> 1) + which * (S // 2)
            hist = (hist >> 1) | (which << 4)
    return out[:, :nbits]


@pytest.fixture
def one_thread():
    """The layout model's many small torch ops on one thread: under
    several test workers a pool of threads each only oversubscribes the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BLOCK_CODES = [((0o1167, 0o1545), 10), ((0o4037, 0o5741), 12),
               ((0o46321, 0o51271, 0o63667, 0o70535), 15),
               ((0o152711, 0o126723), 16)]


@pytest.mark.parametrize("kind", ["hard", "soft"])
@pytest.mark.parametrize("polys,K", BLOCK_CODES)
def test_block_layout_model_is_the_plain_viterbi(polys, K, kind, one_thread):
    """The block and cluster instance's layout (``_block_model``) at the
    planner's geometry for two frames (K = 10: a block of 64 threads of 8
    states; K = 12: a cluster of 2 blocks of 128; K = 15 and 16: clusters
    of 8 blocks of 128 and 256 threads of 16 states): bit-equal to
    viterbi_frames_plain, hard and soft, terminated and not."""
    tabs = tf.viterbi_tables(polys, K, "cpu")
    n, F = len(polys), 2
    for terminated in (True, False):
        _, llr = _frames(polys, K, F, 40, 0.8, seed=K + n, hard=kind == "hard")
        lt = torch.from_numpy(llr).reshape(F, -1, n)
        T = lt.shape[1]
        lay = kfec.viterbi_layout(T, n, K, F)
        assert (lay.instance, lay.E, lay.C) == {
            10: ("block", 8, 1), 12: ("cluster", 8, 2),
            15: ("cluster", 16, 8), 16: ("cluster", 16, 8)}[K]
        nbits = T - (K - 1) if terminated else T
        ref = kfec.viterbi_frames_plain(lt, tabs, terminated, nbits)
        assert torch.equal(_block_model(lt, tabs, terminated, nbits, lay.E,
                                        lay.C), ref)


@pytest.mark.parametrize("polys,K,E,C", [
    ((0o171, 0o133, 0o165, 0o117, 0o127), 7, 2, 1),
    ((0o345, 0o313, 0o277, 0o235, 0o221), 8, 4, 1),
    ((0o4037, 0o5741), 12, 16, 1),
    ((0o4037, 0o5741), 12, 8, 2),
    ((0o46321, 0o51271, 0o63667, 0o70535), 15, 16, 4),
    ((0o152711, 0o126723), 16, 32, 2), ((0o152711, 0o126723), 16, 16, 4)])
def test_block_layout_model_at_other_geometries(polys, K, E, C, one_thread):
    """The same model at the geometries a probe may set and the one-warp
    frames of rate 1/5 (E = 2, 4: no swizzle, 32/E threads a word): the
    bits do not depend on E or C, ties included (all-zero LLRs)."""
    tabs = tf.viterbi_tables(polys, K, "cpu")
    n = len(polys)
    _, llr = _frames(polys, K, 2, 30, 0.8, seed=K * E + C, hard=True)
    for lt in (torch.from_numpy(llr).reshape(2, -1, n),
               torch.zeros(1, 30 + K - 1, n)):
        assert kfec.acs_layout(lt.shape[1], n, K, E, C, 2).E == E
        for terminated in (True, False):
            nbits = lt.shape[1] - (K - 1) if terminated else lt.shape[1]
            assert torch.equal(
                _block_model(lt, tabs, terminated, nbits, E, C),
                kfec.viterbi_frames_plain(lt, tabs, terminated, nbits))


def test_block_swizzle_spreads_each_quarter_warp_over_the_banks():
    """The float4 loads (E/2 metrics at t E/2, and past a block's half) and
    the stores (E at t E) of eight consecutive threads fall in eight
    distinct 16-byte slots of a 128-byte row: no bank conflict."""
    for E in (8, 16, 32):
        for base in (0, 32, 2048):  # a half-row offset, a multiple of 32
            for lo, step, n4 in ((base, E // 2, E // 8), (0, E, E // 4)):
                for q in range(4):
                    for j in range(n4):
                        i = torch.tensor([lo + (8 * q + tt) * step + 4 * j
                                          for tt in range(8)])
                        slots = (_swz(i, E) >> 2) & 7
                        assert len(set(slots.tolist())) == 8, (E, base, j)


# -- S3 past K = 15: its metrics in device memory -------------------------------

K16_POLYS = (0o152711, 0o126723)  # a rate-1/2 code of K = 16 (its
# polynomials share no factor over GF(2): not catastrophic)


@pytest.mark.parametrize("K", [16, 17, 18, 19])
def test_viterbi_plans_codes_past_k15_in_device_memory(K):
    """Past K = 15 a block's shared memory no longer holds a frame's two
    rows of metrics: up to K = 18 (CLUSTER_MAX_K) S3 plans a cluster of 4
    or 8 blocks a frame, the rows split across their shared memory (S/C
    states a block, at most 128 KB), its decision words in device memory;
    past it
    the serial instance with the metrics in device memory too. The device
    bytes are the decision words (and the serial instance's metrics) of
    every frame, and past the card's memory the plan raises, naming
    them."""
    S, T = 1 << (K - 1), 512 + K - 1
    inst = "cluster" if K <= kfec.CLUSTER_MAX_K else "serial"
    assert kfec.viterbi_plan(T, 2, K) == (inst, "global")
    assert kfec.viterbi_plan(2, 1, K) == (inst, "global")
    lay = kfec.viterbi_layout(T, 2, K, 256)
    if inst == "cluster":
        C, E = {16: (4, 16), 17: (8, 16), 18: (8, 32)}[K]
        assert (lay.C, lay.threads, lay.E) == (C, 512, E) == (
            C, S // C // E, E)
        assert lay.smem == 4 * (2 * S // C + 2 * 256 + 2 * C * 16
                                + kfec.ACS_AUX + T * 2)  # the LLRs staged
        assert lay.smem <= kfec.SMEM_MAX
    else:
        assert kfec.viterbi_smem(T, 2, S, "serial", "global") == 4 * 64
    metrics = inst == "serial"
    need = kfec.viterbi_device_bytes(256, T, K)
    assert need == 4 * 256 * (T * S // 32 + (2 * S if metrics else 0))
    assert kfec.viterbi_plan(T, 2, K, 256, need) == (inst, "global")
    with pytest.raises(ValueError, match=f"need {need} B of device memory"):
        kfec.viterbi_plan(T, 2, K, 256, need - 1)
    # K <= 15 keeps its routes, and its bytes are the decision words alone
    assert kfec.viterbi_device_bytes(4, 518, 15) == 4 * 4 * 518 * 512


def test_viterbi_k16_plain_matches_reference():
    """At K = 16 (32768 states) the plain version S3 is held to on the card
    equals the reference's viterbi_decode bit for bit on a short noisy
    frame, terminated and not, and decodes a noiseless frame without
    error."""
    K = 16
    bits, llr = _frames(K16_POLYS, K, 1, 24, 0.8, seed=16)
    for terminated in (True, False):
        got = tf.viterbi_decode(torch.from_numpy(llr[0]), K16_POLYS, K,
                                terminated=terminated)
        ref = np.asarray(jf.viterbi_decode(jnp.asarray(llr[0]), K16_POLYS, K,
                                           terminated=terminated))
        np.testing.assert_array_equal(got.numpy(), ref)
    coded = tf.conv_encode(torch.from_numpy(bits[0]), K16_POLYS, K)
    np.testing.assert_array_equal(
        tf.viterbi_decode(tf.hard_to_llr(coded), K16_POLYS, K).numpy(), bits[0])


@pytest.mark.parametrize("polys,K", [(K16_POLYS, 16), (jf.CC_K7_POLYS, 7),
                                     ((0o171, 0o133, 0o165), 7),
                                     ((0o46321, 0o51271, 0o63667, 0o70535), 15)])
def test_viterbi_symbols_are_parities_of_generators_read_from_psym(polys, K):
    """S3 past K = 15 computes each branch symbol in place of loading it
    (csrc/viterbi.cu): generator j read back from psym (bit k from state
    2^k on branch 0, bit K-1 from state 0 on branch 1), and psym[s][b][j]
    = 2 parity(g_j & (s + b S)) - 1. The read-back equals the code's
    generators and the parities equal psym at every state, branch and
    output, at rates 1/2 to 1/4."""
    _, _, psym = tf._tables_np(tuple(polys), K)
    S, n = psym.shape[0], psym.shape[2]
    lg = S.bit_length() - 1
    flat = psym.reshape(-1)
    gen = [(int(flat[n + j] > 0) << lg)
           | sum(int(flat[(2 << k) * n + j] > 0) << k for k in range(lg))
           for j in range(n)]
    assert gen == list(polys)
    reg = np.arange(S)[:, None] + np.array([0, S])[None, :]  # (S, 2)
    for j, g in enumerate(gen):
        parity = np.array([[bin(g & int(r)).count("1") & 1 for r in row]
                           for row in reg])
        np.testing.assert_array_equal(psym[:, :, j], 2.0 * parity - 1.0)


def test_s3_split_cuts_find_their_anchors():
    """``probes/stages.py s3split`` cuts ``csrc/viterbi.cu``'s block and
    cluster instance ("acs") at anchors that must each be there once, each
    behind its macro; the cuts of the block-a-frame kernel it timed before
    the redesign find theirs in the serial instance, which keeps that
    kernel's text."""
    from newsched_tpu_torch.probes import stages

    text = (_build.CSRC / "viterbi.cu").read_text()
    for form in ("acs", "block-a-frame"):
        cuts, variants = stages._S3_FORMS[form]
        for macro, anchors in cuts.items():
            for anchor, pre, post in anchors:
                assert text.count(anchor) == 1, (form, macro)
            assert any(macro in pre + post for _, pre, post in anchors)
        assert {m for _, ms in variants for m in ms} <= set(cuts)
    assert "viterbi_acs_kernel" in text  # so s3split takes the "acs" form
