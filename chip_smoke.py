#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is the fused 64-channel FM channelizer flowgraph
(``newsched_tpu_torch.models.fm_channelizer(fused=True)``: source ->
fused chain block -> sink, compiled by the rate algebra and stepped by the
runner) at full width: M=64 channels, 16 taps per arm, a 65-tap audio
filter decimating by 8, batches of 2^21 wideband samples.

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
  6. the flowgraph over a replayed noise stream, 4 batches on the GPU:
     >= 95 dB against the float64 golden on the unambiguous samples;
  7. the flowgraph with its default noise source, 4 batches: the same
     gate against the golden of the regenerated stream;
  8. the launch counts of phases 6-7 show K3 and K4 ran on the main path;
  9. times (CUDA events around 10 back-to-back calls, median of 30
     such reps): K3 and K4 beside their plain versions, and the
     flowgraph step in Msamples/s.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

M, L, DECIM, A = 64, 16, 8, 65
DEMOD_GAIN = 0.5
BATCH = 1 << 21            # wideband samples per batch
ROWS = BATCH // M          # planes rows per batch (32768)
N_AUD = ROWS // DECIM      # audio rows per batch (4096)
SNR_GATE_DB = 95.0
K3_TOL = 2e-5              # fused kernel vs its plain version, FP32 both
K2_TOL = 1e-6              # atan2 vs plain and vs float64
REPS = 30


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def flowgraph(source, n_batches: int, sink="vector"):
    from newsched_tpu_torch import models

    taps, audio_taps = design()
    return models.fm_channelizer(
        nchans=M, taps_per_arm=L, audio_decim=DECIM, fused=True, source=source,
        batch_size=BATCH, sink=sink,
        n_samples=None if n_batches is None else n_batches * N_AUD,
        deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN), audio_taps=audio_taps)


def gate(rows: np.ndarray, got: np.ndarray, what: str) -> None:
    from newsched_tpu_torch.testing import rows_reference, snr_db

    taps, audio_taps = design()
    ref, bad = rows_reference(rows, taps, audio_taps, nchans=M,
                              audio_decim=DECIM, demod_gain=DEMOD_GAIN,
                              return_risk=True)
    require(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    require(bool(np.isfinite(got).all()), f"{what}: non-finite audio")
    snr = snr_db(ref[~bad], got[~bad])
    log(f"{what}: {got.shape[0]} audio rows x {M} channels, SNR vs float64 "
        f"golden {snr:.2f} dB on {int((~bad).sum())} samples "
        f"({int(bad.sum())} masked at the branch cut)")
    require(snr >= SNR_GATE_DB, f"{what}: SNR {snr:.2f} dB < {SNR_GATE_DB}")


def phase_replay(rows):
    from newsched_tpu_torch.blocks import general

    fg, blks = flowgraph(general.vector_source(rows, repeat=True), 4)
    fg.run(device="cuda")
    gate(np.concatenate([rows] * 4), blks["sink"].data(), "replay flowgraph")


def phase_noise(torch, noise):
    fg, blks = flowgraph(None, 4)
    fg.run(device="cuda")
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    rows = (noise.gaussian_rows_plain(0, 0, n_rows=4 * ROWS, width=2 * M,
                                      seed=0, device="cuda") * amp).cpu().numpy()
    gate(rows, blks["sink"].data(), "noise-source flowgraph")


def step_rate(torch, source, label: str, card: str) -> float:
    """Device time of one compiled flowgraph step, streaming batch after
    batch (median over REPS runs of 10 steps), as Msamples/s."""
    from newsched_tpu_torch.runtime.runner import Runner

    fg, _ = flowgraph(source, None, sink="null")
    fg.validate()
    runner = Runner(fg, batch_size=fg.batch_size, device="cuda")
    params = runner.init_params()
    box = {"s": runner.init_states()}

    def one():
        box["s"], _ = runner.cfg.step(box["s"], params)

    ms = median_ms(one)
    log(f"flowgraph step ({label}): {ms:.4f} ms per batch of {BATCH} samples"
        f" = {BATCH / ms / 1e3:.1f} Msamples/s [{card}]")
    return ms


def main() -> int:
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.ops.cuda import _build, fm_chain, mathfns, noise
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
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.strip())

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
    phase_noise(torch, noise)
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
    k3 = {}
    for name, fn in (("plain", fm_chain.fm_chain_step_planes_plain),
                     ("kernel", fm_chain.fm_chain_step_planes),
                     ("kernel ", fm_chain.fm_chain_step_planes),
                     ("plain ", fm_chain.fm_chain_step_planes_plain)):
        k3.setdefault(name.strip(), []).append(
            median_ms(lambda: fn(vb, *st, consts, DECIM, DEMOD_GAIN)))
    k3_t256 = median_ms(lambda: fm_chain.fm_chain_step_planes(
        vb, *st, consts, DECIM, DEMOD_GAIN, tile=256))
    k4 = {}
    for name, fn in (("plain", noise.gaussian_rows_plain),
                     ("kernel", noise.gaussian_rows),
                     ("kernel ", noise.gaussian_rows),
                     ("plain ", noise.gaussian_rows_plain)):
        k4.setdefault(name.strip(), []).append(median_ms(
            lambda: fn(0, 0, n_rows=ROWS, width=2 * M, seed=0, device="cuda")))
    k3_ms, k3_plain = min(k3["kernel"]), min(k3["plain"])
    k4_ms, k4_plain = min(k4["kernel"]), min(k4["plain"])
    log(f"K3 fm_chain_step_planes ({ROWS} x {2 * M} rows): kernel "
        f"{k3['kernel']} ms (tile 256: {k3_t256:.4f} ms), plain {k3['plain']} ms "
        f"[{card}]")
    log(f"K4 gaussian_rows ({ROWS} x {2 * M}): kernel {k4['kernel']} ms, "
        f"plain {k4['plain']} ms [{card}]")
    step_rate(torch, general.vector_source(rows, repeat=True), "replay", card)
    step_rate(torch, None, "noise source", card)

    print(json.dumps({"kernels": [
        {"name": "fm_chain_step_planes", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/fm_chain.cu",
         "replaces": "newsched_tpu/ops/pallas/fm_chain.py:421",
         "launches": launches["fm_chain"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain},
        {"name": "gaussian_rows", "route": "cuda",
         "source": "newsched_tpu_torch/csrc/noise.cu",
         "replaces": "newsched_tpu/ops/pallas/noise.py:176",
         "launches": launches["noise"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
