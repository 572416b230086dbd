"""The ablation probe (reference: bench/exp_ablate.py ``make_step``): K3,
``fm_chain_step_planes``, with its stages switched off at compile time, to
see where its time goes. The kernel is K3's own tile routine
(csrc/fm_chain.cu ``chain_tile``, its ``Variant`` switches): "full" is the
shipped K3, bit for bit. The variants, as the reference names them:

- "no_atan2": the demod's atan2(PI, PR) replaced by PR + PI;
- "no_dft": no DFT product (Y = the fold's output);
- "no_fold": one fold tap in place of L;
- "no_audio": no audio FIR (out[o] = aud[o * decim]);
- "no_demod": no demod (aud = Re Y * gain);
- "dma_only": the window loaded and nothing computed (out[o] = the window's
  row o * decim, re lanes).

Only "full" returns the end state (prev, tail); the others return None
for both.
"""

from __future__ import annotations

import ctypes

import torch

from newsched_tpu_torch.ops.cuda import _build, fm_chain
from newsched_tpu_torch.ops.cuda.mathfns import ATAN_COEFFS, atan2_plain

VARIANTS = ("full", "no_atan2", "no_dft", "no_fold", "no_audio", "no_demod",
            "dma_only")


def fm_chain_ablate_plain(vb, halo, prev0, tail0, consts, decim: int,
                          gain: float, variant: str):
    """The plain PyTorch version of ``fm_chain_ablate``: K3's plain
    version with the same stages switched off."""
    if variant == "full":
        return fm_chain.fm_chain_step_planes_plain(vb, halo, prev0, tail0,
                                                   consts, decim, gain)
    L, W = (int(d) for d in consts.c2.shape)
    M = W // 2
    n, H8 = int(vb.shape[0]), int(halo.shape[0])
    if variant == "dma_only":
        return vb[::decim, :M].contiguous(), None, None
    vp = torch.cat([halo, vb])
    off = H8 - (L - 1)
    acc = consts.c2[0] * vp[off:off + n]
    if variant != "no_fold":
        for q in range(1, L):
            acc = acc + consts.c2[q] * vp[off + q:off + q + n]
    Y = acc if variant == "no_dft" else acc @ consts.w2
    P = torch.cat([prev0, Y[:-1]])
    ar, ai, yr, yi = P[:, :M], P[:, M:], Y[:, :M], Y[:, M:]
    pr, pi = ar * yr + ai * yi, ar * yi - ai * yr
    if variant == "no_demod":
        aud = yr * gain
    elif variant == "no_atan2":
        aud = (pr + pi) * gain
    else:
        aud = atan2_plain(pi, pr) * gain
    if variant == "no_audio":
        return aud[::decim].contiguous(), None, None
    A = int(consts.ataps.shape[0])
    audfull = torch.cat([tail0[:, :M], aud])
    n_o = n // decim
    out = torch.zeros((n_o, M), dtype=torch.float32, device=vb.device)
    for k in range(A):
        s = A - 1 - k
        out = out + consts.ataps[k] * audfull[s:s + n_o * decim:decim]
    return out, None, None


def fm_chain_ablate(vb, halo, prev0, tail0, consts, decim: int, gain: float,
                    variant: str = "full"):
    """One batch of K3 with the stages of ``variant`` switched off, K3's
    arguments (warm 0) and its default tile. Returns (audio (n//decim, M), prev, tail), prev
    and tail None but for "full". CPU tensors take the plain version; CUDA
    tensors launch ``fm_chain_ablate_launch`` (csrc/fm_chain.cu)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    L, W = (int(d) for d in consts.c2.shape)
    M, A, n = W // 2, int(consts.ataps.shape[0]), int(vb.shape[0])
    H8 = fm_chain._round8(L - 1)
    tile = fm_chain._pick_tile(n, 128, decim)
    if A - 1 > tile or tile < H8 or int(halo.shape[0]) != H8:
        raise ValueError(f"tile {tile}, halo {tuple(halo.shape)}: K3's "
                         f"conditions (warm 0) do not hold")
    if vb.device.type == "cpu":
        return fm_chain_ablate_plain(vb, halo, prev0, tail0, consts, decim,
                                     gain, variant)
    if W != fm_chain.FLAGSHIP_W:
        raise ValueError(f"planes width {W}: the ablation is built for M=64 "
                         f"channels ({fm_chain.FLAGSHIP_W} lanes)")
    fm_chain._check_kernel_shape(W, tile, A, L, 1, decim)
    dev = vb.device
    fm_chain._check_chain_tensors(dev, [("vb", vb, (n, W)),
                                        ("halo", halo, (H8, W))],
                                  prev0, tail0, consts)
    aud, prev, tail = fm_chain._chain_outputs(n, decim, M, A, dev)
    if variant != "full":
        prev = tail = None
    with torch.cuda.device(dev):
        err = _build.lib().fm_chain_ablate_launch(
            VARIANTS.index(variant), vb.data_ptr(), halo.data_ptr(),
            prev0.data_ptr(), tail0.data_ptr(), consts.c2.data_ptr(),
            consts.fft.data_ptr(), consts.ataps.data_ptr(), aud.data_ptr(),
            None if prev is None else prev.data_ptr(),
            None if tail is None else tail.data_ptr(), n, M, L, H8, A,
            int(decim), tile, H8, 0, float(gain),
            ATAN_COEFFS.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fm_chain_ablate_launch")
    fm_chain_ablate.launches += 1
    return aud, prev, tail


fm_chain_ablate.launches = 0
