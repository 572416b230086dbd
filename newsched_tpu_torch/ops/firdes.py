"""FIR filter design (windowed-sinc) — analog of reference kernel/filter/firdes.

Host-side numpy at float64; returns float32/complex64 tap arrays ready for the
device kernels. API mirrors the reference's firdes: low_pass / high_pass /
band_pass / complex_band_pass with (gain, sampling_freq, cutoff, transition)
signatures, plus helpers used by the resampler and channelizer blocks.
"""

from __future__ import annotations

import numpy as np

from newsched_tpu_torch.ops import window as _window
from newsched_tpu_torch.ops.window import WindowType


def _compute_ntaps(sampling_freq: float, transition_width: float, win, beta: float) -> int:
    atten = _window.max_attenuation(win, beta)
    ntaps = int(atten * sampling_freq / (22.0 * transition_width))
    if (ntaps & 1) == 0:
        ntaps += 1
    return max(ntaps, 3)


def _sinc_lowpass(gain: float, cutoff_norm: float, ntaps: int, win, beta: float) -> np.ndarray:
    """Windowed sinc prototype; cutoff_norm = cutoff / sampling_freq."""
    w = _window.build(win, ntaps, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    fwt0 = 2 * np.pi * cutoff_norm
    # sin(n*fwt0)/(n*pi) with the n=0 limit handled by np.sinc.
    taps = (fwt0 / np.pi) * np.sinc(n * fwt0 / np.pi) * w
    # Normalize to unity gain at DC.
    taps = taps * (gain / np.sum(taps))
    return taps


def low_pass(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    win: WindowType | str = WindowType.HAMMING,
    beta: float = 6.76,
    ntaps: int | None = None,
) -> np.ndarray:
    """Low-pass FIR taps (float32)."""
    if not 0 < cutoff_freq <= sampling_freq / 2:
        raise ValueError("cutoff_freq must be in (0, fs/2]")
    if ntaps is None:
        ntaps = _compute_ntaps(sampling_freq, transition_width, win, beta)
    taps = _sinc_lowpass(gain, cutoff_freq / sampling_freq, ntaps, win, beta)
    return taps.astype(np.float32)


def high_pass(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    win: WindowType | str = WindowType.HAMMING,
    beta: float = 6.76,
    ntaps: int | None = None,
) -> np.ndarray:
    """High-pass FIR taps via spectral inversion of the low-pass prototype."""
    if ntaps is None:
        ntaps = _compute_ntaps(sampling_freq, transition_width, win, beta)
    if (ntaps & 1) == 0:
        ntaps += 1  # high-pass needs a center tap
    lp = _sinc_lowpass(1.0, cutoff_freq / sampling_freq, ntaps, win, beta)
    hp = -lp
    hp[(ntaps - 1) // 2] += 1.0
    # Normalize to unity gain at Nyquist.
    nyq = np.sum(hp * np.cos(np.pi * (np.arange(ntaps) - (ntaps - 1) // 2)))
    hp = hp * (gain / nyq)
    return hp.astype(np.float32)


def band_pass(
    gain: float,
    sampling_freq: float,
    low_cutoff_freq: float,
    high_cutoff_freq: float,
    transition_width: float,
    win: WindowType | str = WindowType.HAMMING,
    beta: float = 6.76,
    ntaps: int | None = None,
) -> np.ndarray:
    """Real band-pass taps: low-pass prototype heterodyned to band center."""
    if not 0 < low_cutoff_freq < high_cutoff_freq <= sampling_freq / 2:
        raise ValueError("need 0 < low < high <= fs/2")
    if ntaps is None:
        ntaps = _compute_ntaps(sampling_freq, transition_width, win, beta)
    width = (high_cutoff_freq - low_cutoff_freq) / 2.0
    center = (high_cutoff_freq + low_cutoff_freq) / 2.0
    lp = _sinc_lowpass(1.0, width / sampling_freq, ntaps, win, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    bp = 2.0 * lp * np.cos(2 * np.pi * center / sampling_freq * n)
    # Normalize gain at band center.
    ref = np.sum(bp * np.cos(2 * np.pi * center / sampling_freq * n))
    bp = bp * (gain / ref)
    return bp.astype(np.float32)


def complex_band_pass(
    gain: float,
    sampling_freq: float,
    low_cutoff_freq: float,
    high_cutoff_freq: float,
    transition_width: float,
    win: WindowType | str = WindowType.HAMMING,
    beta: float = 6.76,
    ntaps: int | None = None,
) -> np.ndarray:
    """Complex band-pass taps (complex64): one-sided band via complex rotation."""
    if ntaps is None:
        ntaps = _compute_ntaps(sampling_freq, transition_width, win, beta)
    width = (high_cutoff_freq - low_cutoff_freq) / 2.0
    center = (high_cutoff_freq + low_cutoff_freq) / 2.0
    lp = _sinc_lowpass(gain, width / sampling_freq, ntaps, win, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps, dtype=np.float64) - m
    rot = np.exp(2j * np.pi * center / sampling_freq * n)
    return (lp * rot).astype(np.complex64)


def root_raised_cosine(
    gain: float, sampling_freq: float, symbol_rate: float, alpha: float, ntaps: int
) -> np.ndarray:
    """RRC pulse-shaping taps (float32) for the digital blocks."""
    ntaps |= 1
    spb = sampling_freq / symbol_rate
    m = (ntaps - 1) // 2
    t = (np.arange(ntaps, dtype=np.float64) - m) / spb
    taps = np.zeros(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif alpha > 0 and abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
            )
        else:
            num = np.sin(np.pi * ti * (1 - alpha)) + 4 * alpha * ti * np.cos(
                np.pi * ti * (1 + alpha)
            )
            den = np.pi * ti * (1 - (4 * alpha * ti) ** 2)
            taps[i] = num / den
    taps = taps * gain / np.sqrt(np.sum(taps**2))
    return taps.astype(np.float32)


def prototype_channelizer_taps(
    nchans: int,
    taps_per_arm: int = 16,
    attenuation_db: float = 80.0,
    gain: float = 1.0,
) -> np.ndarray:
    """Prototype low-pass for an nchans polyphase channelizer (float32).

    Designed at the full input rate with cutoff at half the channel spacing,
    Kaiser-windowed; total length nchans * taps_per_arm.
    """
    ntaps = nchans * taps_per_arm
    beta = 0.1102 * (attenuation_db - 8.7)
    # Odd-length design then truncate/pad to exactly ntaps for clean reshape.
    taps = _sinc_lowpass(gain, 0.5 / nchans, ntaps + 1, WindowType.KAISER, beta)[:-1]
    return taps.astype(np.float32)
