"""Window functions for filter design.

Host-side (numpy, float64) — windows are computed once at graph-construction
time, like the reference's kernel/filter window.{h,cc}. Supported set mirrors
the reference: hamming, hann, blackman, blackman-harris, rectangular, kaiser.
"""

from __future__ import annotations

import enum

import numpy as np


class WindowType(enum.Enum):
    HAMMING = "hamming"
    HANN = "hann"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"
    RECTANGULAR = "rectangular"
    KAISER = "kaiser"


def build(win: WindowType | str, ntaps: int, beta: float = 6.76) -> np.ndarray:
    """Return an ntaps-point symmetric window as float64."""
    if isinstance(win, str):
        win = WindowType(win.lower())
    n = np.arange(ntaps, dtype=np.float64)
    m = ntaps - 1
    if win is WindowType.RECTANGULAR:
        return np.ones(ntaps)
    if win is WindowType.HAMMING:
        return 0.54 - 0.46 * np.cos(2 * np.pi * n / m)
    if win is WindowType.HANN:
        return 0.5 - 0.5 * np.cos(2 * np.pi * n / m)
    if win is WindowType.BLACKMAN:
        return 0.42 - 0.5 * np.cos(2 * np.pi * n / m) + 0.08 * np.cos(4 * np.pi * n / m)
    if win is WindowType.BLACKMAN_HARRIS:
        return (
            0.35875
            - 0.48829 * np.cos(2 * np.pi * n / m)
            + 0.14128 * np.cos(4 * np.pi * n / m)
            - 0.01168 * np.cos(6 * np.pi * n / m)
        )
    if win is WindowType.KAISER:
        return np.i0(beta * np.sqrt(1 - ((2 * n - m) / m) ** 2)) / np.i0(beta)
    raise ValueError(f"unknown window {win}")


def max_attenuation(win: WindowType | str, beta: float = 6.76) -> float:
    """Approximate stopband attenuation (dB) used for transition-width sizing."""
    if isinstance(win, str):
        win = WindowType(win.lower())
    return {
        WindowType.RECTANGULAR: 21.0,
        WindowType.HAMMING: 53.0,
        WindowType.HANN: 44.0,
        WindowType.BLACKMAN: 74.0,
        WindowType.BLACKMAN_HARRIS: 92.0,
        WindowType.KAISER: 0.1102 * beta + 8.7 if beta > 0 else 21.0,
    }[win]
