"""The port's FEC (ops/fec.py: the convolutional encoder, S3 viterbi_decode
and its plain version on the CPU, the interleavers; blocks/fec.py) held
against the JAX package on the same numpy inputs: bit-equal for the
(171/133, K = 7) and (7/5, K = 3) codes, hard and soft; the reference's
own cases mirrored (tests/test_fec.py); the tie-break on an input built to
tie; the encoder -> LLR -> decoder graph at frame 128."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from newsched_tpu.ops import fec as jf

from newsched_tpu_torch.blocks import fec as tfecb, general as tgen
from newsched_tpu_torch.ops import fec as tf
from newsched_tpu_torch.ops.cuda import _build, fec as kfec
from newsched_tpu_torch.runtime.block import SyncBlock
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


class _bits_to_llr(SyncBlock):
    """ri16 hard bits -> rf32 +-1 LLRs (the reference test's YAML block)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.add_input("in", "ri16")
        self.add_output("out", "rf32")

    def work(self, state, ins, params, nout):
        return state, {"out": 2.0 * ins["in"].to(torch.float32) - 1.0}


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
    """On a device tensor (meta stands in for the card) S3 refuses K > 11,
    rate 1/5 and a frame past the block's shared memory, naming each limit;
    with `_build.build` failing it raises, never returning the plain result."""
    def no_build():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "build", no_build)
    meta = dict(device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="K <= 11"):
        kfec.viterbi_frames(torch.empty(2, 40, 2, **meta),
                            tf.viterbi_tables((0o4037, 0o5741), 12, "meta"),
                            12, True)
    with pytest.raises(ValueError, match="n <= 4"):
        kfec.viterbi_frames(torch.empty(2, 40, 5, **meta),
                            tf.viterbi_tables((7, 5, 6, 3, 1), 3, "meta"), 3,
                            True)
    with pytest.raises(ValueError, match="232448 B limit"):
        kfec.viterbi_frames(torch.empty(1, 1800, 2, **meta),
                            tf.viterbi_tables((0o2565, 0o3753), 11, "meta"),
                            11, True)
    with pytest.raises(_build.KernelBuildError):
        tf.viterbi_decode(torch.empty(3, 2 * 134, **meta))
    assert kfec.viterbi_frames.launches == 0
