"""The polyphase channelizer front end as kernels (reference:
newsched_tpu/ops/pallas/channelizer.py ``arm_fold`` and ``arm_fold_dft``).

For the commutator matrix V[i, q] = xfull[i*M + q] (ops/pfb.py), the arm
fold is M independent L-tap FIRs down the columns of V:

    acc[j, q] = sum_{s=0}^{L-1} c[s, q] * V[j + s, q]

and the fused front end adds the phase combine, y[:, k] = e^{-j2pi k/M} *
DFT_q(acc)[:, k]: the plain version as one real (2M x 2M) product with the
interleaved DFT matrix, the kernel K1 as the chains' shared-memory FFT
(``planes_fft``) at M = 64 P, P = 1 .. 16 (64 to 1024 channels); the
kernel takes no other width (ROADMAP.md Queue 3, R1). Both work on the
interleaved float32 view of complex64 data: ``torch.view_as_real(V).reshape(n, 2M)``
is the same memory, so entering and leaving it costs no copy. The kernels
are ``csrc/channelizer.cu``, whose header says how they map onto the
H100.
"""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.ops.cuda import _build
from newsched_tpu_torch.ops.cuda.planes_fft import (CHANNELS, fft_planes,
                                                    planes_fft_table)



def interleave_taps(c: np.ndarray) -> np.ndarray:
    """(L, M) real taps -> (L, 2M) taps matching the interleaved view."""
    return np.repeat(np.asarray(c, np.float32), 2, axis=1)


def interleaved_dft_matrix(M: int) -> np.ndarray:
    """Real (2M, 2M) matrix computing y[:, k] = e^{-j2pi k/M} *
    DFT_q(acc)[:, k] on the interleaved [re, im] layout:
    W2[2q, 2k] = Wr, W2[2q+1, 2k] = -Wi, W2[2q, 2k+1] = Wi,
    W2[2q+1, 2k+1] = Wr."""
    k = np.arange(M)
    W = np.exp(-2j * np.pi * np.outer(k, k) / M) * np.exp(-2j * np.pi * k / M)[None, :]
    W2 = np.zeros((2 * M, 2 * M), dtype=np.float32)
    W2[0::2, 0::2] = W.real
    W2[1::2, 0::2] = -W.imag
    W2[0::2, 1::2] = W.imag
    W2[1::2, 1::2] = W.real
    return W2


def complex_to_interleaved(V: torch.Tensor) -> torch.Tensor:
    """(n, M) complex64 -> (n, 2M) float32 [re, im] interleaved: a view
    (a copy only if V is not contiguous)."""
    return torch.view_as_real(V.contiguous()).reshape(V.shape[0], 2 * V.shape[1])


def interleaved_to_complex(A: torch.Tensor) -> torch.Tensor:
    """(n, 2M) float32 -> (n, M) complex64: a view of contiguous A."""
    return torch.view_as_complex(A.contiguous().reshape(A.shape[0], -1, 2))


def _f32(a, device, *shape) -> torch.Tensor:
    """A constant (host array or tensor) as float32 on ``device``; a tensor
    already there is used as is. Blocks upload theirs once per device
    (ops/pfb.py ``pfb_consts``); a host array is uploaded per call."""
    t = (a.to(device=device, dtype=torch.float32) if isinstance(a, torch.Tensor)
         else torch.tensor(np.asarray(a, np.float32), device=device))
    if tuple(t.shape) != shape:
        raise ValueError(f"constant of shape {tuple(t.shape)}, expected {shape}")
    return t


def arm_fold_plain(v: torch.Tensor, c2: torch.Tensor, n_out: int) -> torch.Tensor:
    """The plain PyTorch version of ``arm_fold`` (the reference's
    ``arm_fold_reference`` sum), rows of v past its end read as 0."""
    L = int(c2.shape[0])
    short = n_out + L - 1 - int(v.shape[0])
    if short > 0:
        v = torch.cat([v, v.new_zeros((short, v.shape[1]))])
    acc = c2[0] * v[:n_out]
    for s in range(1, L):
        acc = acc + c2[s] * v[s:s + n_out]
    return acc


def arm_fold_dft_plain(v: torch.Tensor, c2: torch.Tensor, w2: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """The plain PyTorch version of ``arm_fold_dft``: the fold, then the
    FP32 product with the interleaved DFT matrix."""
    return arm_fold_plain(v, c2, n_out) @ w2


def fft_interleaved(acc: torch.Tensor, fft: torch.Tensor) -> torch.Tensor:
    """K1's phase combine as its FFT instance computes it, in torch
    float32: the interleaved fold rows (n, 2M) as planes rows (re lanes,
    then im), ``planes_fft.fft_planes`` with the table ``fft``, and the
    result interleaved again. On K7's output it gives K1's bits."""
    n, W = acc.shape
    Y = fft_planes(torch.cat([acc[:, 0::2], acc[:, 1::2]], dim=1), fft)
    return torch.stack([Y[:, :W // 2], Y[:, W // 2:]], dim=-1).reshape(n, W)


def _launch_args(v: torch.Tensor, c2: torch.Tensor, n_out: int,
                 tile: int | None):
    W = int(c2.shape[1])
    if tile is not None and tile < 1:
        raise ValueError(f"tile {tile} < 1")
    dev = v.device
    _build.check_tensor(v, "v", device=dev)
    _build.check_tensor(c2, "c2", device=dev)
    if v.dim() != 2 or int(v.shape[1]) != W:
        raise ValueError(f"v of shape {tuple(v.shape)}, expected (rows, {W})")
    out = torch.empty((n_out, W), dtype=torch.float32, device=dev)
    return dev, W, out


def arm_fold(v: torch.Tensor, c2, n_out: int,
             tile: int | None = None) -> torch.Tensor:
    """The arm fold on the interleaved view: v (rows, W) f32 (rows past
    its end read as 0; n_out + L - 1 rows are used), c2 (L, W) taps
    (``interleave_taps``) -> (n_out, W) f32. Any W and L. ``tile``: rows
    per CUDA block (default: one wave, as many thread runs as the card
    holds at once, each as long as that makes it); the output does not
    depend on it.

    CPU tensors take the plain version; CUDA tensors launch
    ``arm_fold_launch`` (csrc/channelizer.cu)."""
    L, W = int(np.shape(c2)[0]), int(np.shape(c2)[1])
    c2 = _f32(c2, v.device, L, W)
    if v.device.type == "cpu":
        return arm_fold_plain(v, c2, n_out)
    dev, W, out = _launch_args(v, c2, n_out, tile)
    with torch.cuda.device(dev):
        err = _build.lib().arm_fold_launch(
            v.data_ptr(), int(v.shape[0]), c2.data_ptr(), out.data_ptr(),
            n_out, W, L, int(tile or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "arm_fold_launch")
    arm_fold.launches += 1
    return out


arm_fold.launches = 0


def arm_fold_dft(v: torch.Tensor, c2, w2, n_out: int,
                 tile: int | None = None, fft=None) -> torch.Tensor:
    """Fold + interleaved DFT in one kernel: v (rows, 2M) f32 interleaved,
    c2 (L, 2M) from ``interleave_taps``, w2 (2M, 2M) from
    ``interleaved_dft_matrix`` (the plain version's) -> Y interleaved
    (n_out, 2M) f32. The kernel takes M in ``planes_fft.CHANNELS`` (64 P,
    P = 1 .. 16): the fold in registers and the shared-memory FFT, which
    takes ``fft`` (``planes_fft_table(M)``, on the device) in place of w2;
    any other M raises (ROADMAP.md Queue 3, R1). ``tile``: rows a thread
    group (P <= 7) or a block (P >= 8) folds in a run (default: one wave
    of runs on the card); the output does not depend on it.

    CPU tensors take the plain version; CUDA tensors launch
    ``arm_fold_fft_launch`` (csrc/channelizer.cu)."""
    L, W = int(np.shape(c2)[0]), int(np.shape(c2)[1])
    M = W // 2
    if v.device.type != "cpu" and M not in CHANNELS:
        raise ValueError(f"arm_fold_dft: width {W} lanes (M={M}); the CUDA "
                         f"kernel takes M = 64 P, P = 1 .. 16 (64 to "
                         f"{CHANNELS[-1]}); other widths are ROADMAP.md "
                         f"Queue 3, R1")
    c2 = _f32(c2, v.device, L, W)
    if v.device.type == "cpu":
        return arm_fold_dft_plain(v, c2, _f32(w2, v.device, W, W), n_out)
    if fft is None:
        raise ValueError("arm_fold_dft: the kernel takes the DFT as an "
                         "FFT and needs its twiddle table: pass fft="
                         "planes_fft_table(M) on the device")
    dev, W, out = _launch_args(v, c2, n_out, tile)
    fft = _f32(fft, dev, 4, M)
    with torch.cuda.device(dev):
        err = _build.lib().arm_fold_fft_launch(
            v.data_ptr(), int(v.shape[0]), c2.data_ptr(), fft.data_ptr(),
            out.data_ptr(), n_out, M, L, int(tile or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "arm_fold_fft_launch")
    arm_fold_dft.launches += 1
    return out


arm_fold_dft.launches = 0


def pfb_arm_fold_complex(V: torch.Tensor, c: np.ndarray, n_out: int,
                         tile: int | None = None) -> torch.Tensor:
    """V (need, M) complex64, c (L, M) real arm coefficients -> acc
    (n_out, M) complex64, through ``arm_fold``."""
    acc = arm_fold(complex_to_interleaved(V), interleave_taps(c), n_out,
                   tile=tile)
    return interleaved_to_complex(acc)


def pfb_channelize_fused(V: torch.Tensor, c: np.ndarray, n_out: int,
                         tile: int | None = None) -> torch.Tensor:
    """V (need, M) complex64, c (L, M) arm coefficients -> Y (n_out, M)
    complex64: the whole channelizer front end (fold + phase combine)
    through ``arm_fold_dft``."""
    M = int(V.shape[1])
    fft = planes_fft_table(M)
    Y = arm_fold_dft(complex_to_interleaved(V), interleave_taps(c),
                     interleaved_dft_matrix(M), n_out, tile=tile,
                     fft=None if fft is None else torch.from_numpy(fft))
    return interleaved_to_complex(Y)
