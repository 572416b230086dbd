"""The prep probe (reference: bench/exp_prep.py ``rk``): can a kernel read
the interleaved cf32 stream and build the fused chain's planes rows itself,
so that no prep pass runs in front of K3? ``planes_unpack``
(csrc/probes.cu) does what ``blocks/vector_dsp.py`` ``cplx_to_planes``
does with torch ops: row k = [re | im] of stream samples kM-(M-1) .. kM,
the M-1 samples before the batch carried from the batch before. On the TPU
the question was whether Mosaic lowers the in-kernel reshape
(Tp, 128) -> (2Tp, 64) that unpacks a packed re plane into 64-lane rows;
the re half of the rows is exactly that row-major reshape of the skewed
stream.
"""

from __future__ import annotations

import torch

from newsched_tpu_torch.ops.cuda import _build


def planes_unpack_plain(x: torch.Tensor, skew: torch.Tensor, M: int = 64):
    """The plain PyTorch version of ``planes_unpack``: ``cplx_to_planes``'
    torch ops. Returns (rows (n, 2M) float32, the next skew (M-1,))."""
    full = torch.cat([skew, x])
    n = int(x.shape[0]) // M
    rows = full[:n * M].reshape(n, M)
    return (torch.cat([rows.real, rows.imag], dim=1).to(torch.float32),
            full[n * M:])


def planes_unpack(x: torch.Tensor, skew: torch.Tensor, M: int = 64):
    """One batch of the cf32 stream ``x`` ((n*M,) complex64) and the M-1
    samples before it (``skew``) as planes rows (n, 2M) float32, and the
    next batch's skew. CPU tensors take the plain version; CUDA tensors
    launch ``planes_unpack_launch`` (M = 64)."""
    n_samp = int(x.shape[0])
    if n_samp % M or tuple(skew.shape) != (M - 1,):
        raise ValueError(f"x of {n_samp} samples, skew {tuple(skew.shape)}: "
                         f"need whole rows of {M} and {M - 1} skew samples")
    if x.device.type == "cpu":
        return planes_unpack_plain(x, skew, M)
    if M != 64:
        raise ValueError(f"M={M}: the kernel is built for M=64 (128 lanes)")
    dev = x.device
    for name, t in (("x", x), ("skew", skew)):
        if t.device != dev or t.dtype != torch.complex64 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} on {t.device}, the kernel "
                             f"takes contiguous complex64 on {dev}")
    n = n_samp // M
    out = torch.empty((n, 2 * M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().planes_unpack_launch(
            x.data_ptr(), skew.data_ptr(), out.data_ptr(), n, M,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "planes_unpack_launch")
    planes_unpack.launches += 1
    return out, x[n_samp - (M - 1):].clone()


planes_unpack.launches = 0
