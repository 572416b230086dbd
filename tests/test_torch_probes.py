"""The bench probes' plain versions on the CPU (newsched_tpu_torch/probes):
``window_copy``'s slot layout, ``planes_unpack`` against the port's and the
reference's ``cplx_to_planes`` and the reference probe's row-major reshape,
and each K3 ablation variant against a numpy statement of the chain with
that stage dropped ("full": K3's plain version, bit for bit). The kernels
themselves run only on the card (chip_smoke.py phase 33)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from newsched_tpu.blocks import vector_dsp as jvd

from newsched_tpu_torch.blocks import vector_dsp as tvd
from newsched_tpu_torch.ops import firdes
from newsched_tpu_torch.ops.cuda import fm_chain
from newsched_tpu_torch.probes import ablate, dma, prep
from newsched_tpu_torch.testing import planes_rows

M, L, A, DECIM, GAIN = 64, 16, 65, 8, 0.5
NP_TOL = 1e-4  # FP32 plain vs the float64 statement, relative to max|out|


@pytest.mark.parametrize("variant, T, H, lanes", [
    ("dbuf", 16, 16, 128), ("single", 32, 16, 128), ("dbuf", 8, 0, 1024),
    ("direct", 64, 0, 512)])
def test_window_copy_writes_each_tiles_first_rows_to_its_own_slot(
        variant, T, H, lanes):
    rng = np.random.default_rng(0)
    NT = 6
    x = torch.from_numpy(rng.standard_normal((NT * T + H, lanes))
                         .astype(np.float32))
    out = dma.window_copy(x, T, H, variant=variant)
    assert out.shape == (NT, dma.OUT_ROWS, lanes)
    for t in range(NT):
        assert torch.equal(out[t], x[t * T:t * T + dma.OUT_ROWS])
    assert dma.window_copy.launches == 0


def test_window_copy_split_planes_are_re_then_im():
    rng = np.random.default_rng(1)
    xr, xi = (torch.from_numpy(rng.standard_normal((4 * 32 + 16, 64))
                               .astype(np.float32)) for _ in range(2))
    out = dma.window_copy(xr, 32, 16, variant="split", xi=xi)
    assert out.shape == (4, 8, 128)
    assert torch.equal(out[2, :, :64], xr[64:72])
    assert torch.equal(out[2, :, 64:], xi[64:72])


def test_window_copy_refuses_what_the_kernel_is_not_built_for():
    x = torch.zeros(16 * 8 + 16, 96)
    with pytest.raises(ValueError, match="lanes"):
        dma.window_copy(x, 16, 16)
    with pytest.raises(ValueError, match="shared memory"):
        dma.window_copy(torch.zeros(2 * 300 + 16, 256), 300, 16)
    with pytest.raises(ValueError, match="both planes"):
        dma.window_copy(torch.zeros(144, 64), 128, 16, variant="split")
    with pytest.raises(ValueError, match="halo"):
        dma.window_copy(torch.zeros(1024, 512), 512, 16, variant="direct")
    with pytest.raises(ValueError, match="variant"):
        dma.window_copy(torch.zeros(144, 128), 128, 16, variant="tma")


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
            ).astype(np.complex64)


def _unpack_against_cplx_to_planes(rows, n_batches, seed=0):
    """``n_batches`` batches of ``rows`` rows with the skew carried:
    planes_unpack's rows and next skew bit-equal to the port's
    cplx_to_planes block, its rows to the reference's. Returns the last
    batch's stream, rows and next skew."""
    blk = tvd.cplx_to_planes(M)
    jblk = jvd.cplx_to_planes(M)
    st = blk.init_state(rows * M, rows, "cpu")
    jst = jblk.init_state(rows * M, rows)
    skew = torch.zeros(M - 1, dtype=torch.complex64)
    for b in range(n_batches):
        x = torch.from_numpy(_stream(rows * M, seed + b))
        got, skew = prep.planes_unpack(x, skew)
        st, ref = blk.work(st, {"in": x.clone()}, {}, rows)
        jst, jref = jblk.work(jst, {"in": jnp.asarray(x.numpy())}, {}, rows)
        assert got.dtype == torch.float32 and got.shape == (rows, 2 * M)
        assert torch.equal(got, ref["out"])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.device_get(jref["out"])))
        assert torch.equal(skew, st["skew"])
    assert prep.planes_unpack.launches == 0
    return x, got, skew


def test_planes_unpack_equals_cplx_to_planes_over_batches():
    """Three batches with the skew carried: bit-equal to the port's
    cplx_to_planes block and to the reference's."""
    _unpack_against_cplx_to_planes(96, 3)


@pytest.mark.parametrize("rows", [1, 33])
def test_planes_unpack_next_skew_is_its_own_storage(rows):
    """The same comparison at row counts off the kernel's 16 rows a block,
    then the batch's buffer overwritten: the returned rows and skew stay.
    On the CPU this holds the wrapper's contract through the plain version
    only (its skew is a slice of a fresh cat); that the kernel writes the
    skew into storage of its own is checked on the card (chip_smoke.py
    phase 33)."""
    x, got, nskew = _unpack_against_cplx_to_planes(rows, 2, seed=11 + rows)
    want, rows_before = x[-(M - 1):].clone(), got.clone()
    x.zero_()
    assert torch.equal(nskew, want)
    assert torch.equal(got, rows_before)


def test_planes_unpack_is_the_reference_probes_row_major_reshape():
    """The re half of the rows is the reference probe's in-kernel unpack:
    the skewed re stream packed as (Tp, 128) rows, reshaped row-major to
    (2Tp, 64) (bench/exp_prep.py ``rk``); the im half likewise."""
    Tp = 128
    x = _stream(2 * Tp * M, 7)
    skew = _stream(M - 1, 8)
    got, _ = prep.planes_unpack(torch.from_numpy(x), torch.from_numpy(skew))
    full = np.concatenate([skew, x])[:2 * Tp * M]
    for half, part in ((slice(0, M), full.real), (slice(M, 2 * M), full.imag)):
        packed = part.astype(np.float32).reshape(Tp, 2 * M)
        np.testing.assert_array_equal(got[:, half].numpy(),
                                      packed.reshape(2 * Tp, M))


def _inputs(n=2048):
    """A 64-station FM band (a slowly modulated carrier at every channel
    centre, as chip_smoke.py's), zero state at stream start, the
    flagship's chain constants."""
    taps = firdes.prototype_channelizer_taps(M, L)
    ataps = firdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    blk = tvd.fm_channelizer_fused_planes(M, taps, ataps, audio_decim=DECIM,
                                          gain=GAIN)
    t = np.arange(n * M)
    x = sum(np.exp(1j * (2 * np.pi * c * t / M + 0.4 / (2 * np.pi * M * fm)
                         * np.sin(2 * np.pi * fm * t + c)))
            for c, fm in ((c, (c + 1) * 1e-6) for c in range(M))) / 8
    rows = torch.from_numpy(planes_rows(x.astype(np.complex64), M))
    H8 = fm_chain._round8(L - 1)
    state = (torch.zeros(H8, 2 * M), torch.zeros(1, 2 * M),
             torch.zeros(A - 1, 2 * M))
    return rows, state, blk.consts("cpu")


def _np_chain(vb, halo, prev0, tail0, consts, variant):
    """The chain in float64 numpy with ``variant``'s stage dropped, and the
    outputs that depend on a demod within the FP32 error of the atan2
    branch cut or in a deep null of conj(prev) * Y (where FP32 and float64
    legitimately disagree; testing.rows_reference masks them the same
    way)."""
    c2, w2, at = (consts.c2.double().numpy(), consts.w2.double().numpy(),
                  consts.ataps.double().numpy())
    vb, halo = vb.double().numpy(), halo.double().numpy()
    if variant == "dma_only":
        return vb[::DECIM, :M], np.zeros((len(vb) // DECIM, M), bool)
    n, H8 = len(vb), len(halo)
    vp = np.concatenate([halo, vb])
    off = H8 - (L - 1)
    taps = 1 if variant == "no_fold" else L
    acc = sum(c2[q] * vp[off + q:off + q + n] for q in range(taps))
    Y = acc if variant == "no_dft" else acc @ w2
    P = np.concatenate([prev0.double().numpy(), Y[:-1]])
    ar, ai, yr, yi = P[:, :M], P[:, M:], Y[:, :M], Y[:, M:]
    pr, pi = ar * yr + ai * yi, ar * yi - ai * yr
    risk = np.zeros_like(pr, bool)
    if variant == "no_demod":
        aud = yr * GAIN
    elif variant == "no_atan2":
        aud = (pr + pi) * GAIN
    else:
        aud = np.where((pr == 0) & (pi == 0), 0.0, np.arctan2(pi, pr)) * GAIN
        mag = np.hypot(pr, pi)
        risk = ((np.abs(pi) < 1e-4 * np.abs(pr)) & (pr < 0)) | (
            (mag > 0) & (mag < 1e-3 * np.median(mag)))
    if variant == "no_audio":
        return aud[::DECIM], risk[::DECIM]
    audfull = np.concatenate([tail0[:, :M].double().numpy(), aud])
    riskfull = np.concatenate([np.zeros((A - 1, M), bool), risk])
    n_o = n // DECIM
    taps = [slice(A - 1 - j, A - 1 - j + n_o * DECIM, DECIM) for j in range(A)]
    return (sum(at[j] * audfull[sl] for j, sl in enumerate(taps)),
            np.any([riskfull[sl] for sl in taps], axis=0))


@pytest.mark.parametrize("variant", ablate.VARIANTS)
def test_ablation_variant_is_the_chain_without_its_stage(variant):
    rows, st, consts = _inputs()
    got, prev, tail = ablate.fm_chain_ablate(rows, *st, consts, DECIM, GAIN,
                                             variant)
    ref, risky = _np_chain(rows, *st, consts, variant)
    assert got.shape == ref.shape == (len(rows) // DECIM, M)
    assert risky.mean() < 0.1, variant  # at most a few cut-ambiguous outputs
    err = np.abs(got.double().numpy() - ref)[~risky].max()
    assert err <= NP_TOL * np.abs(ref).max(), (variant, err)
    full, _, _ = ablate.fm_chain_ablate(rows, *st, consts, DECIM, GAIN)
    if variant == "full":
        k3 = fm_chain.fm_chain_step_planes_plain(rows, *st, consts, DECIM,
                                                 GAIN)
        assert all(torch.equal(a, b) for a, b in zip((got, prev, tail), k3))
    else:
        assert prev is None and tail is None
        assert not torch.equal(got, full)
    assert ablate.fm_chain_ablate.launches == 0


def test_ablation_refuses_an_unknown_variant():
    rows, st, consts = _inputs(128)
    with pytest.raises(ValueError, match="variant"):
        ablate.fm_chain_ablate(rows, *st, consts, DECIM, GAIN, "no_fft")
