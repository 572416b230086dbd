#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the three forms of the 64-channel FM channelizer
flowgraph (``newsched_tpu_torch.models.fm_channelizer``), compiled by the
rate algebra and stepped by the runner, at full width: M=64 channels, 16
taps per arm, a 65-tap audio filter decimating by 8, batches of 2^21
wideband samples:
  - fused (``fused=True``): source -> fused chain block (K3, K2 inside)
    -> sink, with a replayed stream or the noise source (K4);
  - staged (the default ``fused=False``): noise_source (K4) ->
    pfb_channelizer (K1) -> vector_quad_demod -> vector_fir -> sink; and a
    pfb_decimator graph (K7);
  - live (``fused=True, source="live"``): one generating source (K5).

Phases (each failure raises, so the script exits nonzero):
  1. device: a CUDA device is required; its name and power limit;
  2. build: nvcc builds every kernel from newsched_tpu_torch/csrc/;
  3. K4 gaussian_rows at 32768 x 128: bit-equal to its plain version,
     Irwin-Hall moments, split invariance;
  4. K2 atan2 over a (y, x) grid with the axes and signed zeros, and at
     the demod's shape: <= 1e-6 from the plain version and from float64;
  5. K3 fm_chain_step_planes at n=32768 rows, two batches with carried
     state on a 64-station FM band: <= 2e-5 from the plain version, and
     bit-identical outputs for three tile sizes;
  6. the fused flowgraph over a replayed noise stream, 4 batches on the
     GPU: >= 95 dB against the float64 golden on the unambiguous samples;
  7. the fused flowgraph with its default noise source, 4 batches: the
     same gate against the golden of the regenerated stream;
  8. the launch counts of phases 6-7 show K3 and K4 ran on that path;
  9. times (CUDA events around 10 back-to-back calls, median of 30
     such reps): K3 and K4 beside their plain versions, and the fused
     flowgraph step in Msamples/s;
 10. K7 arm_fold and K1 arm_fold_dft on the FM band's commutator matrix:
     within 1e-5 of max|out| from their plain versions, bit-identical at
     tiles 128 and 256; K1 also at 128, 192 and 256 channels, where
     pfb_channelize's "auto" must launch it;
 11. the staged flowgraph with its default noise source, 4 batches:
     >= 60 dB against the golden of the regenerated stream; K1 and K4
     launched on it;
 12. a pfb_decimator graph at channel 5 equals column 5 of the
     pfb_channelizer graph within 1e-5 relative; K7 launched on it;
 13. K5 fm_chain_gen_step, 2 carried batches, draws 3 and 2: bit-equal to
     K4 * amp -> K3 at the same tile, bit-identical at tiles 64/128/256,
     within 2e-5 of its plain version outside the golden's branch-cut
     mask;
 14. the live flowgraph, 4 batches: bit-equal to phase 7's output (the
     same stream) and >= 95 dB against its golden; K5 launched on it; a
     two-draw live flowgraph equals phase 13's first batch;
 15. times: K1, K7 and K5 beside their plain versions (and K5 beside
     K4 -> K3), the staged and live flowgraph steps in Msamples/s.

Each timed flowgraph step is also traced for 20 steps with
torch.profiler and its device time printed kernel by kernel.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

M, L, DECIM, A = 64, 16, 8, 65
DEMOD_GAIN = 0.5
BATCH = 1 << 21            # wideband samples per batch
ROWS = BATCH // M          # planes rows per batch (32768)
N_AUD = ROWS // DECIM      # audio rows per batch (4096)
SNR_GATE_DB = 95.0         # fused and live chains (the reference's gate)
STAGED_GATE_DB = 60.0      # the staged graph (the reference's gate for it)
K3_TOL = 2e-5              # fused kernel vs its plain version, FP32 both
K5_TOL = 2e-5              # generating kernel vs its plain version
K2_TOL = 1e-6              # atan2 vs plain and vs float64
FOLD_TOL = 1e-5            # K1/K7 vs plain, relative to max|out|
DEC_TOL = 1e-5             # pfb_decimator vs the channelizer's column
DEC_CHANNEL = 5
REPS = 30
PLAIN_REPS = 10            # the slow plain versions of K1, K7, K5
_GOLDEN: dict = {}         # float64 goldens by stream, computed once


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_name(ptxas_line: str) -> str:
    """The kernel's name in ptxas' 'Compiling entry function' line: the
    length-prefixed part of the mangled name that ends in _kernel."""
    for m in re.finditer(r"(?=(\d+))", ptxas_line):  # every digit suffix
        n = m.group(1)
        name = ptxas_line[m.start() + len(n):m.start() + len(n) + int(n)]
        if name.endswith("_kernel") and name.isidentifier():
            return name
    return "?"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = REPS, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` back-to-back
    calls, divided by ``inner``; the median over ``reps`` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


def design():
    from newsched_tpu_torch.ops import firdes

    taps = firdes.prototype_channelizer_taps(M, L)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.4 / DECIM, 0.1 / DECIM, ntaps=A)
    return taps, audio_taps


def fm_band(n_samples: int, device) -> np.ndarray:
    """A 64-station FM band: one carrier at each channel centre k/M, each
    frequency-modulated by its own tone so that the demodulated angle per
    channel sample stays within +-0.4 rad, far from the +-pi branch cut
    (a kernel-vs-plain comparison of noise would flip there on a 1-ulp
    difference)."""
    import torch

    n = torch.arange(n_samples, dtype=torch.float64, device=device)
    x = torch.zeros(n_samples, dtype=torch.complex128, device=device)
    for k in range(M):
        fm = (k + 1) * 1e-6                       # message tone, cycles/sample
        beta = 0.4 / (2 * np.pi * M * fm)         # peak step 0.4 rad/channel sample
        phase = 2 * np.pi * k * n / M + beta * torch.sin(2 * np.pi * fm * n + k)
        x += torch.polar(torch.ones_like(phase), phase)
    return (x / 8).to(torch.complex64).cpu().numpy()


def phase_k4(torch, noise):
    dev = "cuda"
    rows = noise.gaussian_rows(0, 0, n_rows=ROWS, width=2 * M, seed=5, device=dev)
    plain = noise.gaussian_rows_plain(0, 0, n_rows=ROWS, width=2 * M, seed=5,
                                      device=dev)
    err = float((rows - plain).abs().max())
    require(torch.equal(rows, plain), f"K4: kernel != plain version ({err})")
    r = rows.double().cpu().numpy()
    n = r.size
    mean, std, mx = abs(r.mean()), r.std(), np.abs(r).max()
    kurt = float(np.mean(r**4) / np.mean(r**2) ** 2 - 3.0)
    log(f"K4 moments: |mean| {mean:.3e} (< {5/np.sqrt(n):.3e}), std {std:.6f}, "
        f"max|x| {mx:.4f}, excess kurtosis {kurt:.4f}")
    require(mean < 5 / np.sqrt(n) and abs(std - 1) < 0.01 and mx <= 4.25
            and abs(kurt + 0.2) < 0.05, "K4: moments out of bounds")
    half = ROWS // 2
    hi, lo = noise.advance_groups(0, 0, half // noise.GROUP_ROWS)
    parts = torch.cat([
        noise.gaussian_rows(0, 0, n_rows=half, width=2 * M, seed=5, device=dev),
        noise.gaussian_rows(hi, lo, n_rows=half, width=2 * M, seed=5, device=dev)])
    require(torch.equal(parts, rows), "K4: two half batches != one batch")
    log(f"K4: bit-equal to plain (max abs err {err}); split-invariant")
    return err


def phase_k2(torch, mathfns):
    vals = np.array([-3.0, -1.0, -1e-3, -1e-30, -0.0, 0.0, 1e-30, 1e-3, 1.0,
                     3.0], np.float32)
    rng = np.random.default_rng(2)
    y = np.concatenate([np.repeat(vals, len(vals)),
                        rng.standard_normal(1 << 20).astype(np.float32)])
    x = np.concatenate([np.tile(vals, len(vals)),
                        rng.standard_normal(1 << 20).astype(np.float32)])
    yt, xt = torch.from_numpy(y).cuda(), torch.from_numpy(x).cuda()
    got = mathfns.atan2(yt, xt)
    plain = mathfns.atan2_plain(yt, xt)
    g = got.cpu().numpy()
    err_plain = float(np.abs(g - plain.cpu().numpy()).max())
    # angles compared modulo 2 pi: on the negative real axis a signed zero
    # y puts IEEE atan2 at -pi where the polynomial (like the reference's)
    # gives +pi
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    ref[(x == 0) & (y == 0)] = 0.0
    err_f64 = float(np.abs(np.angle(np.exp(1j * (g - ref)))).max())
    zeros = (x == 0) & (y == 0)
    log(f"K2 atan2: max err vs plain {err_plain:.3e}, vs float64 {err_f64:.3e}; "
        f"(+-0, +-0) -> {np.unique(g[zeros])}")
    require(err_plain <= K2_TOL and err_f64 <= K2_TOL, "K2: error above 1e-6")
    require(np.all(g[zeros] == 0) and not np.any(np.signbit(g[zeros])),
            "K2: (+-0, +-0) is not +0")
    # at the demod's shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    d = torch.randn(2, ROWS, M, device="cuda", generator=gen)
    err = float((mathfns.atan2(d[0], d[1])
                 - mathfns.atan2_plain(d[0], d[1])).abs().max())
    log(f"K2 at ({ROWS}, {M}): max err vs plain {err:.3e}")
    require(err <= K2_TOL, "K2: error above 1e-6 at the demod's shape")


def chain_consts():
    """The fused block's chain constants (fold taps, DFT matrix, audio
    taps) on the GPU."""
    from newsched_tpu_torch.blocks import vector_dsp

    taps, audio_taps = design()
    return vector_dsp.fm_channelizer_fused_planes(
        M, taps, audio_taps, audio_decim=DECIM).consts("cuda")


def phase_k3(torch, fm_chain):
    from newsched_tpu_torch.testing import planes_rows

    consts = chain_consts()
    rows = torch.from_numpy(planes_rows(fm_band(2 * BATCH, "cuda"), M)).cuda()
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")

    def run(step, **kw):
        halo, prev, tail = torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z), \
            torch.zeros(A - 1, 2 * M, **z)
        outs = []
        for b in range(2):
            vb = rows[b * ROWS:(b + 1) * ROWS]
            aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM,
                                   DEMOD_GAIN, **kw)
            outs += [aud, prev, tail]
            halo = vb[-H8:].contiguous()
        return outs

    got = run(fm_chain.fm_chain_step_planes)
    ref = run(fm_chain.fm_chain_step_planes_plain)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    log(f"K3 fm_chain_step_planes: 2 batches x {ROWS} rows, max abs err vs "
        f"plain (audio, prev, tail) {err:.3e} (tol {K3_TOL})")
    require(err <= K3_TOL, "K3: kernel disagrees with its plain version")
    for tile in (256, 64):
        other = run(fm_chain.fm_chain_step_planes, tile=tile)
        require(all(torch.equal(a, b) for a, b in zip(got, other)),
                f"K3: tile {tile} output differs from tile 128")
    log("K3: tiles 128, 256, 64 give bit-identical audio, prev and tail")
    return err


def flowgraph(source, n_batches: int, sink="vector", fused=True, **kw):
    from newsched_tpu_torch import models

    taps, audio_taps = design()
    return models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=DECIM, fused=fused,
        source=source, batch_size=BATCH, sink=sink,
        n_samples=None if n_batches is None else n_batches * N_AUD,
        deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN), audio_taps=audio_taps,
        **kw)


def golden(rows: np.ndarray, key: str):
    """The float64 golden of planes rows and its branch-cut mask, computed
    once per stream ``key``."""
    from newsched_tpu_torch.testing import rows_reference

    if key not in _GOLDEN:
        taps, audio_taps = design()
        _GOLDEN[key] = rows_reference(rows, taps, audio_taps, nchans=M,
                                      audio_decim=DECIM, demod_gain=DEMOD_GAIN,
                                      return_risk=True)
    return _GOLDEN[key]


def gate(rows: np.ndarray, got: np.ndarray, what: str, key: str,
         gate_db: float = SNR_GATE_DB) -> float:
    from newsched_tpu_torch.testing import snr_db

    ref, bad = golden(rows, key)
    require(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    require(bool(np.isfinite(got).all()), f"{what}: non-finite audio")
    snr = snr_db(ref[~bad], got[~bad])
    log(f"{what}: {got.shape[0]} audio rows x {M} channels, SNR vs float64 "
        f"golden {snr:.2f} dB on {int((~bad).sum())} samples "
        f"({int(bad.sum())} masked at the branch cut; gate {gate_db} dB)")
    require(snr >= gate_db, f"{what}: SNR {snr:.2f} dB < {gate_db}")
    return snr


def phase_replay(rows):
    from newsched_tpu_torch.blocks import general

    fg, blks = flowgraph(general.vector_source(rows, repeat=True), 4)
    fg.run(device="cuda")
    gate(np.concatenate([rows] * 4), blks["sink"].data(), "replay flowgraph",
         "replay")


def noise_rows(torch, noise, n_batches: int, draws: int = 3) -> np.ndarray:
    """The default noise stream (seed 0) x 0.5 as planes rows, regenerated
    by the plain generator on the GPU."""
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    return (noise.gaussian_rows_plain(0, 0, n_rows=n_batches * ROWS,
                                      width=2 * M, seed=0, device="cuda",
                                      draws=draws) * amp).cpu().numpy()


def phase_noise(torch, noise) -> np.ndarray:
    fg, blks = flowgraph(None, 4)
    fg.run(device="cuda")
    got = blks["sink"].data()
    gate(noise_rows(torch, noise, 4), got, "noise-source flowgraph", "noise")
    return got


def step_rate(torch, source, label: str, card: str, **kw) -> float:
    """Device time of one compiled flowgraph step, streaming batch after
    batch (median over REPS runs of 10 steps), as Msamples/s."""
    from newsched_tpu_torch.runtime.runner import Runner

    fg, _ = flowgraph(source, None, sink="null", **kw)
    fg.validate()
    runner = Runner(fg, batch_size=fg.batch_size, device="cuda")
    params = runner.init_params()
    box = {"s": runner.init_states()}

    def one():
        box["s"], _ = runner.cfg.step(box["s"], params)

    ms = median_ms(one)
    log(f"flowgraph step ({label}): {ms:.4f} ms per batch of {BATCH} samples"
        f" = {BATCH / ms / 1e3:.1f} Msamples/s [{card}]")
    profile_steps(torch, one, label)
    return ms


def profile_steps(torch, step, label: str, n: int = 20) -> None:
    """Device time per step, kernel by kernel, over n traced steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / n / 1e3, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    log(f"profile ({label}): device kernels {sum(r[0] for r in rows):.4f} ms "
        f"per step")
    for ms, count, key in rows:
        log(f"  {ms:.4f} ms x{count:g} {key[:100]}")


def fold_consts(torch, channelizer):
    """K7/K1 constants of the flagship channelizer on the GPU: fold taps
    (L, 2M) and the interleaved DFT matrix (2M, 2M)."""
    from newsched_tpu_torch.ops import pfb

    taps, _ = design()
    c = pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T.copy()
    return (torch.from_numpy(channelizer.interleave_taps(c)).cuda(),
            torch.from_numpy(channelizer.interleaved_dft_matrix(M).copy()).cuda())


def commutator(torch, channelizer, x: np.ndarray):
    """The interleaved commutator matrix of a stream's first batch, as the
    staged channelizer builds it: (ROWS + L - 1, 2M) f32 on the GPU."""
    xfull = np.concatenate([np.zeros(M * L - 1, np.complex64), x])
    V = torch.from_numpy(xfull[:(ROWS + L - 1) * M].reshape(-1, M)).cuda()
    return channelizer.complex_to_interleaved(V)


def phase_k1_k7(torch, channelizer) -> dict:
    c2, w2 = fold_consts(torch, channelizer)
    v = commutator(torch, channelizer, fm_band(BATCH, "cuda"))
    errs = {}
    for name, args in (("arm_fold", (c2,)), ("arm_fold_dft", (c2, w2))):
        kernel = getattr(channelizer, name)
        plain = getattr(channelizer, name + "_plain")
        got, ref = kernel(v, *args, ROWS), plain(v, *args, ROWS)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"{name}: {ROWS} x {2 * M} rows, max abs err vs plain {err:.3e} "
            f"= {err / scale:.3e} of max|out| {scale:.3f} (tol {FOLD_TOL})")
        require(err <= FOLD_TOL * scale, f"{name}: kernel disagrees with plain")
        require(torch.equal(got, kernel(v, *args, ROWS, tile=256)),
                f"{name}: tile 256 output differs from tile 128")
        errs[name] = err
    log("K7, K1: tiles 128 and 256 give bit-identical outputs")
    errs["arm_fold_dft"] = max(errs["arm_fold_dft"],
                               *(k1_wide(torch, channelizer, m) for m in (128, 192, 256)))
    return errs


def k1_wide(torch, channelizer, m: int, n_out: int = 4096) -> float:
    """K1 at m channels (2m lanes): "auto" in pfb_channelize launches it,
    it agrees with its plain version, and its default tile (fewer rows at
    wider rows) gives the bits of tile 48."""
    from newsched_tpu_torch.ops import firdes, pfb

    arm = pfb.pfb_arm_taps(firdes.prototype_channelizer_taps(m, L), m)
    consts = pfb.pfb_consts(arm, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(n_out * m, dtype=torch.complex64, device="cuda", generator=gen)
    before = channelizer.arm_fold_dft.launches
    pfb.pfb_channelize(arm, pfb.pfb_init_state(m * L, "cuda"), x, consts=consts)
    require(channelizer.arm_fold_dft.launches == before + 1,
            f"pfb_channelize auto at M={m} did not launch K1")
    xfull = torch.cat([torch.zeros(m * L - 1, dtype=x.dtype, device="cuda"), x])
    v = channelizer.complex_to_interleaved(
        xfull[:(n_out + L - 1) * m].reshape(-1, m))
    got = channelizer.arm_fold_dft(v, consts.c2, consts.w2, n_out)
    ref = channelizer.arm_fold_dft_plain(v, consts.c2, consts.w2, n_out)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"arm_fold_dft at M={m}: {n_out} x {2 * m} rows, max abs err vs plain "
        f"{err:.3e} = {err / scale:.3e} of max|out| (tol {FOLD_TOL}); launched "
        f"by pfb_channelize auto")
    require(err <= FOLD_TOL * scale, f"K1 at M={m} disagrees with plain")
    require(torch.equal(got, channelizer.arm_fold_dft(v, consts.c2, consts.w2,
                                                      n_out, tile=48)),
            f"K1 at M={m}: tile 48 differs from the default tile")
    return err


def phase_staged(torch, noise, channelizer) -> dict:
    fg, blks = flowgraph(None, 4, fused=False)
    channelizer.arm_fold_dft.launches = 0
    noise.gaussian_rows.launches = 0
    fg.run(device="cuda")
    launches = {"arm_fold_dft": channelizer.arm_fold_dft.launches,
                "gaussian_rows": noise.gaussian_rows.launches}
    log(f"launches on the staged path: {launches}")
    require(all(n > 0 for n in launches.values()),
            "a kernel of the staged path was never launched")
    from newsched_tpu_torch.testing import planes_rows

    r = noise.gaussian_rows_plain(0, 0, n_rows=4 * ROWS, width=128, seed=0,
                                  device="cuda")
    x = (torch.complex(r[:, :64].reshape(-1), r[:, 64:].reshape(-1))
         * 0.5).cpu().numpy()
    gate(planes_rows(x, M), blks["sink"].data(), "staged flowgraph", "staged",
         STAGED_GATE_DB)
    return launches


def phase_decimator(torch, channelizer) -> int:
    from newsched_tpu_torch import Flowgraph
    from newsched_tpu_torch.blocks import filter as filt, general

    taps, _ = design()
    x = fm_band(2 * BATCH, "cuda")
    out = {}
    for name, blk, vlen in (
            ("channelizer", filt.pfb_channelizer(M, taps=taps), (M,)),
            ("decimator", filt.pfb_decimator(M, DEC_CHANNEL, taps=taps), ())):
        fg = Flowgraph(batch_size=BATCH)
        snk = general.vector_sink(dtype="cf32", vlen=vlen)
        fg.connect(general.vector_source(x), 0, blk, 0)
        fg.connect(blk, 0, snk, 0)
        channelizer.arm_fold.launches = 0
        fg.run(device="cuda")
        out[name] = (snk.data(), channelizer.arm_fold.launches)
    ref = out["channelizer"][0][:, DEC_CHANNEL]
    got, launches = out["decimator"]
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"pfb_decimator channel {DEC_CHANNEL}: {got.shape[0]} samples, max "
        f"err {err:.3e} of max|y| vs the channelizer's column (tol {DEC_TOL}); "
        f"arm_fold launches {launches}")
    require(got.shape == ref.shape and err <= DEC_TOL,
            "pfb_decimator disagrees with the channelizer")
    require(launches > 0, "K7 was never launched on the decimator path")
    return launches


def gen_batches(torch, fm_chain, noise, consts, draws, step, **kw):
    """Two carried batches of the live chain from stream start: K5
    (``step`` = fm_chain_gen_step) or a composition (noise -> chain).
    Returns [aud, prev, tail, carry] per batch."""
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    carry, prev, tail = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
                         torch.zeros(A - 1, 2 * M, **z))
    outs = []
    for b in range(2):
        hi, lo = noise.advance_groups(0, 0, b * ROWS // noise.GROUP_ROWS)
        aud, prev, tail, carry = step(hi, lo, amp, carry, prev, tail, consts,
                                      DECIM, DEMOD_GAIN, ROWS, draws=draws, **kw)
        outs += [aud, prev, tail, carry]
    return outs


def composed(rows_fn, chain_fn):
    """A K5-shaped step from a noise generator and a chain step."""
    def step(hi, lo, amp, carry, prev, tail, consts, decim, gain, n, draws,
             **kw):
        rows = rows_fn(hi, lo, n_rows=n, width=2 * M, seed=0, device="cuda",
                       draws=draws) * amp
        aud, prev, tail = chain_fn(rows, carry, prev, tail, consts, decim,
                                   gain, **kw)
        return aud, prev, tail, rows[-carry.shape[0]:].contiguous()
    return step


def phase_k5(torch, fm_chain, noise):
    """K5 against K4 -> K3, across tiles and against its plain version;
    returns (worst error vs plain, the two-draw stream's first audio)."""
    consts = chain_consts()
    worst = 0.0
    for draws in (3, 2):
        got = gen_batches(torch, fm_chain, noise, consts, draws,
                          fm_chain.fm_chain_gen_step)
        k4k3 = gen_batches(torch, fm_chain, noise, consts, draws,
                           composed(noise.gaussian_rows,
                                    fm_chain.fm_chain_step_planes), tile=128)
        require(all(torch.equal(a, b) for a, b in zip(got, k4k3)),
                f"K5 draws={draws}: differs from K4 * amp -> K3")
        for tile in (64, 256):
            other = gen_batches(torch, fm_chain, noise, consts, draws,
                                fm_chain.fm_chain_gen_step, tile=tile)
            require(all(torch.equal(a, b) for a, b in zip(got, other)),
                    f"K5 draws={draws}: tile {tile} differs from tile 128")
        plain = gen_batches(torch, fm_chain, noise, consts, draws,
                            fm_chain.fm_chain_gen_step_plain)
        # draws=3 is phase 7's stream: its golden's first two batches
        _, bad = (golden(noise_rows(torch, noise, 2, draws), "noise draws=2")
                  if draws == 2 else golden(None, "noise"))
        bad = bad[:2 * N_AUD]
        aud = torch.cat([got[0], got[4]]).cpu().numpy()
        aud_p = torch.cat([plain[0], plain[4]]).cpu().numpy()
        err = float(np.abs(aud - aud_p)[~bad].max())
        err_prev = max(float((got[i] - plain[i]).abs().max()) for i in (1, 5))
        err_carry = max(float((got[i] - plain[i]).abs().max()) for i in (3, 7))
        log(f"K5 fm_chain_gen_step draws={draws}: bit-equal to K4 * amp -> K3 "
            f"and across tiles 64/128/256; vs plain: audio {err:.3e} on "
            f"{int((~bad).sum())} unmasked samples, prev {err_prev:.3e}, "
            f"carry {err_carry:.3e} (tol {K5_TOL})")
        require(max(err, err_prev) <= K5_TOL and err_carry == 0.0,
                f"K5 draws={draws}: disagrees with its plain version")
        worst = max(worst, err, err_prev)
        if draws == 2:
            first_batch_d2 = got[0]
    return worst, first_batch_d2


def phase_live(torch, fm_chain, noise, fused_out, first_batch_d2) -> int:
    fg, blks = flowgraph("live", 4)
    fm_chain.fm_chain_gen_step.launches = 0
    fg.run(device="cuda")
    launches = fm_chain.fm_chain_gen_step.launches
    got = blks["sink"].data()
    log(f"launches on the live path: fm_chain_gen_step {launches}")
    require(launches > 0, "K5 was never launched on the live path")
    require(np.array_equal(got, fused_out),
            "live flowgraph differs from the fused noise-source flowgraph")
    gate(None, got, "live flowgraph (bit-equal to the noise-source "
         "flowgraph)", "noise")
    fg, blks = flowgraph("live", 1, noise_draws=2)
    fg.run(device="cuda")
    require(np.array_equal(blks["sink"].data(), first_batch_d2.cpu().numpy()),
            "two-draw live flowgraph differs from K5's first batch")
    log("live flowgraph noise_draws=2: bit-equal to K5's first batch")
    return launches


def alternate(fns: dict, plain_reps: int = REPS) -> dict:
    """median_ms of each named call, twice: in the reverse of the given
    order, then in it, so each kernel and its plain version alternate.
    Calls named '... plain' take ``plain_reps`` reps."""
    names = list(fns)
    out: dict = {}
    for name in names[::-1] + names:
        reps = plain_reps if name.endswith(" plain") else REPS
        out.setdefault(name, []).append(median_ms(fns[name], reps=reps))
    return out


def main() -> int:
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.ops.cuda import (_build, channelizer, fm_chain,
                                             mathfns, noise)
    from newsched_tpu_torch.testing import planes_rows

    import torch  # after the port, so a copy without it fails before torch loads

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. device
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.monotonic()
    built = _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s (nvcc, sm_90a)")
    kernel = "?"
    for line in built.log.splitlines():
        if "entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: " + line.split(":", 1)[-1].strip())

    # 3-5. the kernels against their plain versions
    k4_err = phase_k4(torch, noise)
    phase_k2(torch, mathfns)
    k3_err = phase_k3(torch, fm_chain)

    # 6-8. the main path, counted
    rng = np.random.default_rng(0)
    x = ((rng.standard_normal(BATCH) + 1j * rng.standard_normal(BATCH))
         * 0.5).astype(np.complex64)
    rows = planes_rows(x, M)
    fm_chain.fm_chain_step_planes.launches = 0
    noise.gaussian_rows.launches = 0
    phase_replay(rows)
    fused_out = phase_noise(torch, noise)
    launches = {"fm_chain": fm_chain.fm_chain_step_planes.launches,
                "noise": noise.gaussian_rows.launches}
    log(f"launches on the main path: fm_chain_step_planes "
        f"{launches['fm_chain']}, gaussian_rows {launches['noise']}")
    require(launches["fm_chain"] > 0 and launches["noise"] > 0,
            "a kernel of the main path was never launched")

    # 9. times
    H8 = fm_chain._round8(L - 1)
    consts = chain_consts()
    vb = torch.from_numpy(rows).cuda()
    z = dict(dtype=torch.float32, device="cuda")
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    t = alternate({
        "K3 plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K4 plain": lambda: noise.gaussian_rows_plain(
            0, 0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
        "K4": lambda: noise.gaussian_rows(
            0, 0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
    })
    k3_t256 = median_ms(lambda: fm_chain.fm_chain_step_planes(
        vb, *st, consts, DECIM, DEMOD_GAIN, tile=256))
    log(f"K3 fm_chain_step_planes ({ROWS} x {2 * M} rows): kernel "
        f"{t['K3']} ms (tile 256: {k3_t256:.4f} ms), plain {t['K3 plain']} ms "
        f"[{card}]")
    log(f"K4 gaussian_rows ({ROWS} x {2 * M}): kernel {t['K4']} ms, "
        f"plain {t['K4 plain']} ms [{card}]")
    step_rate(torch, general.vector_source(rows, repeat=True), "replay", card)
    step_rate(torch, None, "noise source", card)

    # 10-14. the staged and live paths, each counted
    fold_err = phase_k1_k7(torch, channelizer)
    staged = phase_staged(torch, noise, channelizer)
    dec_launches = phase_decimator(torch, channelizer)
    k5_err, first_batch_d2 = phase_k5(torch, fm_chain, noise)
    live_launches = phase_live(torch, fm_chain, noise, fused_out,
                               first_batch_d2)

    # 15. times
    c2, w2 = fold_consts(torch, channelizer)
    v = commutator(torch, channelizer, x)
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    k5_rows = composed(noise.gaussian_rows, fm_chain.fm_chain_step_planes)
    k5_args = (0, 0, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS)
    t.update(alternate({
        "K7 plain": lambda: channelizer.arm_fold_plain(v, c2, ROWS),
        "K7": lambda: channelizer.arm_fold(v, c2, ROWS),
        "K1 plain": lambda: channelizer.arm_fold_dft_plain(v, c2, w2, ROWS),
        "K1": lambda: channelizer.arm_fold_dft(v, c2, w2, ROWS),
        "K5 plain": lambda: fm_chain.fm_chain_gen_step_plain(*k5_args),
        "K4 -> K3": lambda: k5_rows(*k5_args, draws=3),
        "K5": lambda: fm_chain.fm_chain_gen_step(*k5_args),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    for name, what in (("K7", "arm_fold"), ("K1", "arm_fold_dft"),
                       ("K5", "fm_chain_gen_step")):
        log(f"{name} {what} ({ROWS} x {2 * M} rows): kernel {t[name]} ms, "
            f"plain {t[name + ' plain']} ms [{card}]")
    log(f"K4 * amp -> K3 (what K5 fuses): {t['K4 -> K3']} ms [{card}]")
    step_rate(torch, None, "staged", card, fused=False)
    step_rate(torch, "live", "live", card)

    print(json.dumps({"kernels": [
        {"name": "fm_chain_step_planes", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/fm_chain.cu",
         "replaces": "newsched_tpu/ops/pallas/fm_chain.py:421",
         "launches": launches["fm_chain"], "max_abs_err": k3_err,
         "ms": ms["K3"], "plain_ms": ms["K3 plain"]},
        {"name": "gaussian_rows", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/noise.cu",
         "replaces": "newsched_tpu/ops/pallas/noise.py:176",
         "launches": launches["noise"], "max_abs_err": k4_err,
         "ms": ms["K4"], "plain_ms": ms["K4 plain"]},
        {"name": "arm_fold_dft", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/channelizer.cu",
         "replaces": "newsched_tpu/ops/pallas/channelizer.py:209",
         "launches": staged["arm_fold_dft"],
         "max_abs_err": fold_err["arm_fold_dft"],
         "ms": ms["K1"], "plain_ms": ms["K1 plain"]},
        {"name": "arm_fold", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/channelizer.cu",
         "replaces": "newsched_tpu/ops/pallas/channelizer.py:95",
         "launches": dec_launches, "max_abs_err": fold_err["arm_fold"],
         "ms": ms["K7"], "plain_ms": ms["K7 plain"]},
        {"name": "fm_chain_gen_step", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/fm_chain.cu",
         "replaces": "newsched_tpu/ops/pallas/fm_chain.py:591",
         "launches": live_launches, "max_abs_err": k5_err,
         "ms": ms["K5"], "plain_ms": ms["K5 plain"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
