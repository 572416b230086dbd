"""The probes' measurements on the card, as records (dicts), one a case:
what ``python3 -m newsched_tpu_torch.probes`` prints and chip_smoke.py's
phase 34 reads. Every time is a device time (``_timing.graph_ms``); rates
are the input's bytes over that time, beside the card's 3.35 TB/s. The
copies read from device memory, not from the 50 MB L2 cache: each call
takes the next of ``ROT`` copies of its input (67 MB and more in all), as
a stream's batches would come."""

from __future__ import annotations

import numpy as np
import torch

from newsched_tpu_torch.probes import ablate, dma, prep
from newsched_tpu_torch.probes._timing import graph_ms

PEAK_GBPS = 3350.0     # H100 SXM HBM3, GB/s (published)
ROWS = 1 << 15         # 32768 rows x 128 lanes f32 = 16.8 MB (exp_dma.py)
H8 = 16                # K3's window halo
NTOT = 1 << 22         # f32 elements of the per-row sweep (exp_dma2.py)
DMA_TILES = (32, 64, 128, 192)  # two slots of (T + 16) x 128 fit 227 KB
K3_TILE = 128          # K3's tile: its window is the shape that counts
ROT = 4                # copies of an input the calls rotate over (> L2)


def rotating(make, call):
    """A call over ``ROT`` inputs from ``make(i)``, the next one each time
    (inside a captured graph too: the capture records the rotation)."""
    inputs = [make(i) for i in range(ROT)]
    state = {"i": 0}

    def fn():
        state["i"] = (state["i"] + 1) % ROT
        return call(*inputs[state["i"]])
    return fn


def _rec(case: str, ms: float, nbytes: int, **kw) -> dict:
    gbps = nbytes / (ms * 1e-3) / 1e9
    return {"case": case, **kw, "us": ms * 1e3, "gbps_read": gbps,
            "share_of_peak": gbps / PEAK_GBPS}


def dma_sweep(reps: int = 10) -> list[dict]:
    """exp_dma.py, exp_dma64.py and exp_dma2.py on the card."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    x = rotating(lambda i: (randn(ROWS + H8, 128),), lambda v: v)
    nbytes = (ROWS + H8) * 128 * 4
    out = []
    c = torch.tensor(1.0001, device=dev)
    ms = graph_ms(lambda: x() * c, reps)
    out.append({**_rec("torch_mul_stream", ms, nbytes),
                "gbps_rw": 2 * nbytes / (ms * 1e-3) / 1e9})
    out.append(_rec("torch_clone", graph_ms(lambda: x().clone(), reps),
                    nbytes))
    for variant in ("dbuf", "single"):
        for T in DMA_TILES:
            ms = graph_ms(lambda: dma.window_copy(x(), T, H8, variant=variant),
                          reps)
            out.append(_rec(f"dma_{variant}", ms, nbytes, tile=T,
                            us_per_tile=ms * 1e3 / (ROWS // T)))
    planes = rotating(lambda i: (randn(ROWS + H8, 64), randn(ROWS + H8, 64)),
                      lambda xr, xi: (xr, xi))
    def split(T):
        xr, xi = planes()
        return dma.window_copy(xr, T, H8, variant="split", xi=xi)

    for T in (64, K3_TILE):
        ms = graph_ms(lambda: split(T), reps)
        out.append(_rec("dma64_split", ms, nbytes, tile=T,
                        us_per_tile=ms * 1e3 / (ROWS // T)))
    for W in dma.LANES["dbuf"]:
        x2 = rotating(lambda i: (randn(NTOT // W, W),), lambda v: v)
        T = 16384 // W  # 64 KB a slot
        ms = graph_ms(lambda: dma.window_copy(x2(), T, 0), reps)
        out.append(_rec("dma_row_lanes", ms, NTOT * 4, row_lanes=W,
                        tile_rows=T))
    # the reference's (512, 512) tile (1 MB: 16 blocks), and 64 KB tiles
    # (one block a tile, as the copies above) that fill the card
    x5 = rotating(lambda i: (randn(NTOT // 512, 512),), lambda v: v)
    for T in (512, 32):
        ms = graph_ms(lambda: dma.window_copy(x5(), T, 0, variant="direct"),
                      reps)
        out.append(_rec("direct_512", ms, NTOT * 4, tile_rows=T))
    return out


def chain_inputs(n_rows: int = ROWS, seed: int = 0):
    """A batch of K3's inputs at the flagship's shape: a cf32 stream of
    n_rows * 64 samples, its planes rows, zero state, the chain's
    constants."""
    from newsched_tpu_torch.blocks import vector_dsp
    from newsched_tpu_torch.ops import firdes

    M, L, A, decim = 64, 16, 65, 8
    taps = firdes.prototype_channelizer_taps(M, L)
    ataps = firdes.low_pass(1.0, 1.0, 0.4 / decim, 0.1 / decim, ntaps=A)
    blk = vector_dsp.fm_channelizer_fused_planes(M, taps, ataps,
                                                 audio_decim=decim)
    rng = np.random.default_rng(seed)
    xc = ((rng.standard_normal(n_rows * M) + 1j * rng.standard_normal(
        n_rows * M)) * 0.5).astype(np.complex64)
    x = torch.from_numpy(xc).cuda()
    skew = torch.zeros(M - 1, dtype=torch.complex64, device="cuda")
    rows, _ = prep.planes_unpack_plain(x, skew, M)
    z = dict(dtype=torch.float32, device="cuda")
    state = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
             torch.zeros(A - 1, 2 * M, **z))
    return x, skew, rows, state, blk.consts("cuda"), decim, 0.5


def prep_times(reps: int = 10) -> list[dict]:
    """exp_prep.py on the card: K3 on preformed planes (a), the torch prep
    pass then K3 (b), planes_unpack then K3 (c), and the unpack alone."""
    from newsched_tpu_torch.ops.cuda import fm_chain

    x0, skew, rows0, st, consts, decim, gain = chain_inputs()
    nbytes = x0.numel() * 8
    x = rotating(lambda i: (x0.clone(),), lambda v: v)
    rows = rotating(lambda i: (rows0.clone(),), lambda v: v)

    def k3(v):
        return fm_chain.fm_chain_step_planes(v, *st, consts, decim, gain)

    t = {"kernel_only": graph_ms(lambda: k3(rows()), reps),
         "production_torch_prep": graph_ms(
             lambda: k3(prep.planes_unpack_plain(x(), skew)[0]), reps),
         "production_planes_unpack": graph_ms(
             lambda: k3(prep.planes_unpack(x(), skew)[0]), reps)}
    out = [{"case": k, "us_per_step": ms * 1e3,
            "msps": x0.numel() / (ms * 1e-3) / 1e6} for k, ms in t.items()]
    out.append(_rec("planes_unpack", graph_ms(
        lambda: prep.planes_unpack(x(), skew), reps), nbytes))
    out.append(_rec("cplx_to_planes_torch", graph_ms(
        lambda: prep.planes_unpack_plain(x(), skew), reps), nbytes))
    return out


def ablate_times(reps: int = 10) -> list[dict]:
    """exp_ablate.py on the card: each variant of K3 at the flagship's
    batch, beside K3 (alternated: K3, variants, variants reversed, K3)."""
    from newsched_tpu_torch.ops.cuda import fm_chain

    _, _, rows, st, consts, decim, gain = chain_inputs()
    fns = {"K3": lambda: fm_chain.fm_chain_step_planes(rows, *st, consts,
                                                       decim, gain)}
    for v in ablate.VARIANTS:
        fns[v] = (lambda v=v: ablate.fm_chain_ablate(rows, *st, consts, decim,
                                                     gain, v))
    names = list(fns)
    ms: dict = {}
    for name in names + names[::-1]:
        ms.setdefault(name, []).append(graph_ms(fns[name], reps))
    n_tiles = int(rows.shape[0]) // K3_TILE
    return [{"variant": name, "us": min(v) * 1e3,
             "us_per_tile": min(v) * 1e3 / n_tiles,
             "msps": rows.shape[0] * 64 / (min(v) * 1e-3) / 1e6}
            for name, v in ms.items()]
