"""Polyphase filterbank helpers (reference: newsched_tpu/ops/pfb.py).

The maximally-decimated M-channel analysis bank splits the prototype into
per-arm taps g_p[l] = h[lM + p]; the fused chain (ops/cuda/fm_chain.py)
folds the planes-rows stream with them. Only the tap partition is needed
by the fused slice; the staged channelizer comes with the staged slice.
"""

from __future__ import annotations

import numpy as np


def pfb_arm_taps(taps: np.ndarray, nchans: int) -> np.ndarray:
    """Partition prototype taps into per-arm taps g[p, l] = h[l*M + p].

    Pads the prototype with zeros up to a multiple of nchans (same as the
    reference, which rounds the prototype up to fill all arms).
    """
    taps = np.asarray(taps)
    L = -(-taps.shape[0] // nchans)
    padded = np.zeros(L * nchans, dtype=taps.dtype)
    padded[: taps.shape[0]] = taps
    return padded.reshape(L, nchans).T.copy()  # (M, L)
