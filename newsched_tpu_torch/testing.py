"""Golden models for checking the port, in numpy/scipy (float64).

``rows_reference`` is the JAX package's benchmark golden
(``bench.rows_reference``) with the flagship's constants as arguments, and
``planes_rows`` is the port's ``parallel.channelizer.planes_rows``;
``wbfm_golden`` and ``fxpt_tone`` are the wideband-FM receiver's golden
(``tests/test_wbfm_fused.py`` ``golden_chain``, ``bench.py``'s config #1
gate); ``fir_golden`` is config #0's (``tests/test_models.py``,
``bench.py``'s config #0 gate). All are needed where jax is not installed
(the machine with the GPU).
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.ops.pfb import pfb_arm_taps
from newsched_tpu_torch.parallel.channelizer import planes_rows  # noqa: F401


def rows_reference(rows: np.ndarray, taps, audio_taps, nchans: int = 64,
                   audio_decim: int = 8, demod_gain: float = 0.5,
                   return_risk: bool = False):
    """Float64 golden model of the chain over PLANES ROWS (zero pre-stream
    halo/state): PFB channelizer, demod, per-channel audio FIR.

    return_risk additionally returns a boolean audio-sample mask of
    BRANCH-CUT-AMBIGUOUS outputs: demodulating pure noise occasionally
    lands within the compute error floor of the atan2 +-pi cut (or in a
    deep |conj(prev)*Y| null), where golden and kernel legitimately
    disagree by ~2*pi. The mask covers the audio FIR footprint of each
    risky channel sample."""
    import scipy.signal as sig

    M = int(nchans)
    arm = pfb_arm_taps(np.asarray(taps).astype(np.float64), M)  # (M, L)
    L = arm.shape[1]
    C = rows[:, :M].astype(np.float64) + 1j * rows[:, M:].astype(np.float64)
    n_out = C.shape[0]
    V = np.concatenate([np.zeros((L - 1, M), np.complex128), C],
                       axis=0)[:, ::-1].T  # U[p, i]
    filt = np.empty((M, n_out), np.complex128)
    for p in range(M):
        filt[p] = np.correlate(V[p], arm[p][::-1], mode="valid")[:n_out]
    Y = (M * np.fft.ifft(filt, axis=0)).T  # (n_out, M)
    prev = np.vstack([np.zeros((1, M), np.complex128), Y[:-1]])
    P = np.conj(prev) * Y
    # Demod against zero history emits exactly 0 (atan2 of signed zeros
    # is a convention no two backends share).
    aud = np.where((prev == 0) | (Y == 0), 0.0, np.angle(P)) * demod_gain
    at = np.asarray(audio_taps).astype(np.float64)
    out = np.empty((n_out // audio_decim, M), np.float64)
    for c in range(M):
        out[:, c] = sig.lfilter(at, [1.0], aud[:, c])[::audio_decim]
    if not return_risk:
        return out
    med = np.median(np.abs(P))
    risk = ((np.abs(P.imag) < 3e-4 * np.maximum(np.abs(P.real), med * 1e-2))
            & (P.real < 0)) | (np.abs(P) < 1e-3 * med)
    spread = sig.lfilter(np.ones(len(at)), [1.0], risk.astype(np.float64), axis=0)
    bad = (spread > 0)[::audio_decim][: out.shape[0]]
    return out, bad


def fxpt_tone(n: int, dphase: int, amp: float = 1.0) -> np.ndarray:
    """float64 amp * e^{j 2 pi acc(k) / 2^32} on the exact fixed-point
    ladder acc(k) = k * dphase mod 2^32 (the NCO sources' tone)."""
    acc = (np.arange(n, dtype=np.uint64) * np.uint64(dphase)) \
        & np.uint64(0xFFFFFFFF)
    return amp * np.exp(2j * np.pi * (acc.astype(np.float64) / 2.0**32))


def wbfm_golden(x, chan_taps, dphase: int, decim: int, resamp_taps,
                resamp_decim: int, gain: float) -> np.ndarray:
    """Float64 staged-semantics golden of the wideband-FM receiver
    (config #1) from stream start: fixed-point-NCO rotation by -dphase,
    decimating channel FIR, quadrature demod with the zero-history pin,
    decimating resampler FIR."""
    import scipy.signal as sig

    rot = np.conj(fxpt_tone(len(x), dphase))
    u = sig.lfilter(np.asarray(chan_taps, np.complex128), 1.0,
                    np.asarray(x, np.complex128) * rot)[::decim]
    up = np.concatenate([[0.0], u[:-1]])
    d = np.where((up == 0) | (u == 0), 0.0, np.angle(np.conj(up) * u)) * gain
    return sig.lfilter(np.asarray(resamp_taps, np.float64), 1.0, d)[::resamp_decim]


def fir_golden(n: int, taps, freq: float, fs: float) -> np.ndarray:
    """Float64 golden of config #0 from stream start: the tone on the exact
    fixed-point phase ladder at ``freq`` (the NCO's uint32 increment, not
    the real frequency, which drifts from it), through the FIR
    (scipy.signal.lfilter, zero initial state)."""
    import scipy.signal as sig

    from newsched_tpu_torch.ops.nco import freq_to_dphase

    x = fxpt_tone(int(n), freq_to_dphase(freq, fs))
    return sig.lfilter(np.asarray(taps, np.float64), 1.0, x)


def assemble_ranks(parts, n_batches: int) -> np.ndarray:
    """The output of a process mesh in time order: ``parts[r]`` is rank
    r's output over ``n_batches`` batches, its own rows of each batch one
    after the other; batch by batch, the ranks' rows in rank order (as
    the reference's tests/test_multihost.py interleaves them)."""
    per = [np.split(np.asarray(p), n_batches) for p in parts]
    return np.concatenate([p[b] for b in range(n_batches) for p in per])


def assemble_channels(parts) -> np.ndarray:
    """The output of a channel-sharded process mesh (the complex-sample
    channelizer step's, the reference's ``P(None, "t")``): ``parts[r]`` is
    rank r's channel block, its rows the whole of every batch in time
    order; the blocks side by side in rank order, row by row, so batch b's
    rows hold batch b of every rank."""
    parts = [np.asarray(p) for p in parts]
    if len({p.shape[0] for p in parts}) != 1:
        raise ValueError(f"ranks' rows differ: {[p.shape for p in parts]}")
    return np.concatenate(parts, axis=1)


def snr_db(ref, test) -> float:
    """10*log10(mean|ref|^2 / mean|ref-test|^2), real or complex; inf when
    equal."""
    ref = np.asarray(ref)
    ref = ref.astype(np.complex128 if np.iscomplexobj(ref) else np.float64)
    err = ref - np.asarray(test).astype(ref.dtype)
    e = np.mean(np.abs(err) ** 2)
    p = np.mean(np.abs(ref) ** 2)
    return np.inf if e == 0 else float(10 * np.log10(p / e))
