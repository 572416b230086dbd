#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the three forms of the 64-channel FM channelizer
flowgraph (``newsched_tpu_torch.models.fm_channelizer``) and of the
wideband-FM receiver (``models.wbfm_receiver``), compiled by the rate
algebra and stepped by the runner, at full width. The channelizer: M=64
channels, 16 taps per arm, a 65-tap audio filter decimating by 8, batches
of 2^21 wideband samples:
  - fused (``fused=True``): source -> fused chain block (K3, K2 inside)
    -> sink, with a replayed stream or the noise source (K4);
  - staged (the default ``fused=False``): noise_source (K4) ->
    pfb_channelizer (K1) -> vector_quad_demod -> vector_fir -> sink; and a
    pfb_decimator graph (K7);
  - live (``fused=True, source="live"``): one generating source (K5).
The wideband-FM receiver (BASELINE config #1): 1 MS/s, an 81-tap channel
filter at 200 kHz decimating by 4, a 121-tap resampler decimating by 5,
75 kHz deviation, batches of 2,088,960 samples, on the fixed-point tone at
231.25 kHz:
  - staged: sig_source (K8) -> freq_xlating_fir -> quadrature_demod ->
    rational_resampler;
  - fused: sig_source (K8) -> wbfm_rcv_fused (K10), and sig_source_folded
    (K11) -> wbfm_rcv_fused(input_format="folded") (K10);
  - live: wbfm_live_source (K12), one generating source.
Config #0, the FIR chain (``models.fir_chain``): a 123,456 Hz fixed-point
tone at 1 MS/s through a 128-tap lowpass FIR, 10,000,000 samples in
batches of 2^21:
  - staged: sig_source (K8) -> fir_filter (the FP32 Toeplitz product) ->
    head;
  - live: fir_tone_source (K9), one generating source -> head.
And the fused channelizer chain's pipelined form,
``fm_chain_step_planes(pipelined=True)`` (K3p). Runs of two batches or
more take the runner's graph mode (a captured CUDA graph of a chunk of
steps, the reference's scan mode), which phase 30 holds against its loop
mode. Then the same graphs sharded, ``fg.run(mesh=make_mesh(n))`` for n = 4 and 8 logical shards on
the one card (``newsched_tpu_torch.parallel``): the live channelizer (K6
per shard), the fused channelizer (K3 per shard with warm > 0), and the
receiver's fused (K10 per shard) and live (K12) forms and the live FIR
chain (K9), each against its unsharded graph.

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
     K4 -> K3), the staged and live flowgraph steps in Msamples/s; K7
     beside one library call computing its function (a grouped conv1d);
 16. K8 nco_planes and K11 nco_folded at 2,088,960 samples: bit-equal to
     their plain versions, on a tone with a nonzero start phase and on
     phases a hair below a whole turn (quadrant 4 wraps to 0);
 17. K10 wbfm_chain_step on an FM signal, 2 carried batches: <= 2e-5 from
     its plain version, carry equal; bit-identical audio at four (tile,
     segment group) geometries and for one batch of twice the size;
 18. K12 wbfm_chain_live_step, 2 carried batches from stream start:
     bit-equal to K11 -> K10, <= 2e-5 from its plain version;
 19. the staged, fused (cf32 and folded) and live wbfm_receiver graphs, 4
     batches each: >= 60 dB against the float64 golden (the reading is
     printed); K8 launched on the staged and fused paths, K11 and K10 on
     the folded one, K10 on the fused one, K12 on the live one;
 20. times: K8, K11, K10, K12 beside their plain versions (K12 beside
     K11 -> K10), K10 at the four geometries, the four wbfm flowgraph
     steps in Msamples/s;
 21. K9 fir_tone_step at 2^21 samples, 128 taps, D = 1 and 4, two batches
     from stream start and one from a nonzero phase: within 2e-5 of
     max|out| from its plain version; bit-identical at seven block
     geometries and for four batches of 2^20 against two of 2^21;
 22. the staged and live fir_chain graphs at 10M samples in batches of
     2^21: >= 60 dB against the float64 golden each (the reading is
     printed), live against staged > 100 dB; K8 launched on the staged
     path, K9 on the live one;
 23. K3p on two carried batches of the FM band, counted: bit-equal to K3
     (audio, prev, tail), bit-identical at tiles 128 and 64 and at 1, 2
     and 4 tiles a block;
 24. times: K2 alone at the demod's shape beside its plain version and
     torch.atan2; K9 beside its plain version and K11 ->
     conv1d(groups=128), at each geometry; K3p beside K3 (alternated), at each tile and tiles a
     block; the config #0 flowgraph steps in Msamples/s;
 25. K6 fm_chain_gen_warm_step at 8192 and 4096 rows (a shard of a 4- and
     of an 8-shard batch), at stream start, at shard 3 and at group
     2^32-2, draws 3 and 2: bit-equal to K5's stream at the same rows,
     within K5_TOL of its plain version outside the golden's branch-cut
     mask;
 26. the live flowgraph sharded over 4 and 8 shards, 3 batches: bit-equal
     to the unsharded live flowgraph, >= 95 dB against its golden; K6
     launched n times a batch, K5 never;
 27. the fused flowgraph over the replayed stream sharded over 4 and 8
     shards, 3 batches: bit-equal to the unsharded one, >= 95 dB; K3
     launched n times a batch; on shard 1 of each mesh, K3 with warm > 0
     within K3_TOL of its plain version off the branch cut, and K3p with
     warm > 0 bit-equal to K3;
 28. the wbfm fused (K8 -> K10 per shard) and live (K12 per shard) graphs
     and the live fir_chain graph (K9 per shard) over 4 and 8 shards, 3
     batches: bit-equal to their unsharded graphs, >= 60 dB each; launches
     counted; K10, K12 and K9 on two shards of each mesh against their
     plain versions;
 29. times: K6 at 8192 and 32768 rows beside K5 and its plain version;
     the sharded live and fused flowgraph steps in Msamples/s (the
     4-shard live step profiled);
 30. graph mode, the runner's default on the card (a captured CUDA graph
     of runtime/runner.py's GRAPH_CHUNK steps over the stream state on
     the card): every unsharded graph (config #2 fused replay, fused
     noise, staged, live; config #1 staged, fused, folded, live; config #0
     staged, live) and the 4-shard live and fused graphs run by fg.run()
     for 2C + 1 batches (two replays and a remainder): bit-equal to
     Runner._run_loop with the same launch counts, each kernel of the path
     among them, above their gates on the batches the goldens cover;
 31. parameter changes under graph mode: a dphase change between runs of
     one runner, in sig_source and in the live receiver, keeps the captured
     chunk and equals a fresh runner's output; a center_freq change (a
     fence) captures anew and equals a fresh runner's output;
 32. K4 and K5 from the sources' counter on the card at group 2^32-2 and
     at a negative group: K4 bit-equal to its plain version, K5 to K4 -> K3;
 33. the probes (newsched_tpu_torch/probes): window_copy in every variant
     exactly its plain version, planes_unpack bit-equal to cplx_to_planes,
     K3's ablation "full" bit-equal to K3 and each variant within K3_TOL
     of max(1, max|out|) of its plain version;
 34. times: each cell's graph-mode step by the bench's two-point fit beside
     its loop-mode step and profiled device time; the graph chunk at 2, 4,
     8 and 16 steps; the bench's timer on its headline path (K1 = 10,
     K2 = 40); the probes (window copies in GB/s beside 3.35 TB/s, the
     prep pass, the ablation beside K3), counted; and every kernel's least
     time on the card for its work (``kernel_bounds``).

Kernel times are device times: 10 calls captured in a CUDA graph and the
graph replayed under CUDA events (median of 30), so the host's launch
time is left out (``graph_ms``); plain versions and flowgraph steps are
timed as a caller runs them, host included (``median_ms``). Each timed
unsharded flowgraph step, and one sharded one, is also traced for 20 steps
with torch.profiler and its device time printed kernel by kernel.

The bench probes (window copies, the planes unpack, K3's ablation) run
last, through ``newsched_tpu_torch.probes.run``, the probes' entry point.

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
LOOP: dict = {}            # cell -> (loop-mode step ms, profiled device ms)


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
    rows = noise.gaussian_rows(0, n_rows=ROWS, width=2 * M, seed=5, device=dev)
    plain = noise.gaussian_rows_plain(0, n_rows=ROWS, width=2 * M, seed=5,
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
    parts = torch.cat([
        noise.gaussian_rows(0, n_rows=half, width=2 * M, seed=5, device=dev),
        noise.gaussian_rows(half // noise.GROUP_ROWS, n_rows=half, width=2 * M,
                            seed=5, device=dev)])
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


def k3_batches(torch, fm_chain, consts, rows, step, **kw):
    """Two carried batches of ROWS planes rows through ``step`` (K3, its
    plain version, or K3p): [aud, prev, tail] per batch."""
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    halo, prev, tail = torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z), \
        torch.zeros(A - 1, 2 * M, **z)
    outs = []
    for b in range(2):
        vb = rows[b * ROWS:(b + 1) * ROWS]
        aud, prev, tail = step(vb, halo, prev, tail, consts, DECIM, DEMOD_GAIN,
                               **kw)
        outs += [aud, prev, tail]
        halo = vb[-H8:].contiguous()
    return outs


def band_rows(torch):
    """Two batches of the FM band as planes rows on the GPU."""
    from newsched_tpu_torch.testing import planes_rows

    return torch.from_numpy(planes_rows(fm_band(2 * BATCH, "cuda"), M)).cuda()


def phase_k3(torch, fm_chain):
    consts = chain_consts()
    rows = band_rows(torch)
    got = k3_batches(torch, fm_chain, consts, rows, fm_chain.fm_chain_step_planes)
    ref = k3_batches(torch, fm_chain, consts, rows,
                     fm_chain.fm_chain_step_planes_plain)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    log(f"K3 fm_chain_step_planes: 2 batches x {ROWS} rows, max abs err vs "
        f"plain (audio, prev, tail) {err:.3e} (tol {K3_TOL})")
    require(err <= K3_TOL, "K3: kernel disagrees with its plain version")
    for tile in (256, 64):
        other = k3_batches(torch, fm_chain, consts, rows,
                           fm_chain.fm_chain_step_planes, tile=tile)
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
         gate_db: float = SNR_GATE_DB, n_batches: int | None = None) -> float:
    """SNR of ``got`` against the golden of stream ``key`` (its first
    ``n_batches`` batches where given) on the samples off the branch cut."""
    from newsched_tpu_torch.testing import snr_db

    ref, bad = golden(rows, key)
    if n_batches is not None:
        ref, bad = ref[:n_batches * N_AUD], bad[:n_batches * N_AUD]
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
    got = blks["sink"].data()
    gate(np.concatenate([rows] * 4), got, "replay flowgraph", "replay")
    return got


def noise_rows(torch, noise, n_batches: int, draws: int = 3) -> np.ndarray:
    """The default noise stream (seed 0) x 0.5 as planes rows, regenerated
    by the plain generator on the GPU."""
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    return (noise.gaussian_rows_plain(0, n_rows=n_batches * ROWS,
                                      width=2 * M, seed=0, device="cuda",
                                      draws=draws) * amp).cpu().numpy()


def phase_noise(torch, noise) -> np.ndarray:
    fg, blks = flowgraph(None, 4)
    fg.run(device="cuda")
    got = blks["sink"].data()
    gate(noise_rows(torch, noise, 4), got, "noise-source flowgraph", "noise")
    return got


def fg_step_rate(torch, fg, label: str, card: str, n_in: int,
                 mesh=None, profile: bool = True) -> float:
    """Device time of one compiled flowgraph step, streaming batch after
    batch (median over REPS runs of 10 steps), as Msamples/s of its
    ``n_in`` input samples; then, with ``profile``, a profile of the
    step."""
    from newsched_tpu_torch.runtime.runner import Runner

    fg.validate()
    runner = Runner(fg, batch_size=fg.batch_size, device="cuda", mesh=mesh)
    params = runner.init_params()
    box = {"s": runner.init_states()}

    def one():
        box["s"], _ = runner.cfg.step(box["s"], params)

    ms = median_ms(one)
    log(f"flowgraph step ({label}): {ms:.4f} ms per batch of {n_in} samples"
        f" = {n_in / ms / 1e3:.1f} Msamples/s [{card}]")
    LOOP[label] = (ms, profile_steps(torch, one, label) if profile else None)
    return ms


def step_rate(torch, source, label: str, card: str, mesh=None,
              profile: bool = True, **kw) -> float:
    fg, _ = flowgraph(source, None, sink="null", **kw)
    return fg_step_rate(torch, fg, label, card, BATCH, mesh, profile)


def profile_steps(torch, step, label: str, n: int = 20) -> float:
    """Device time per step, kernel by kernel, over n traced steps; returns
    the total in ms. The trace sometimes loses a window's device events
    (a kernel counted 0.6 times a step): then it traces again, up to
    three times, and keeps the last."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / n / 1e3, e.count / n, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_time_total > 0), reverse=True)
        if all(float(c).is_integer() for _, c, _ in rows):
            break
    total = sum(r[0] for r in rows)
    log(f"profile ({label}): device kernels {total:.4f} ms per step")
    for ms, count, key in rows:
        log(f"  {ms:.4f} ms x{count:g} {key[:100]}")
    return total


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

    r = noise.gaussian_rows_plain(0, n_rows=4 * ROWS, width=128, seed=0,
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
        g = noise.group_tensor(b * ROWS // noise.GROUP_ROWS, "cuda")
        aud, prev, tail, carry = step(g, amp, carry, prev, tail, consts,
                                      DECIM, DEMOD_GAIN, ROWS, draws=draws, **kw)
        outs += [aud, prev, tail, carry]
    return outs


def composed(rows_fn, chain_fn):
    """A K5-shaped step from a noise generator and a chain step."""
    def step(g, amp, carry, prev, tail, consts, decim, gain, n, draws, **kw):
        rows = rows_fn(g, n_rows=n, width=2 * M, seed=0, device="cuda",
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


# -- config #1: the wideband-FM receiver ------------------------------------

WB_FS, WB_FC, WB_D, WB_RD, WB_DEV = 1e6, 200e3, 4, 5, 75e3
WB_TONE = 231_250.0        # 31.25 kHz into the 100 kHz channel
WB_BATCH = 2_088_960       # samples per batch (the reference bench's)
WB_R = WB_BATCH // 64      # folded rows per batch (32640)
WB_NAUD = WB_R // (WB_D * WB_RD)  # audio rows per batch (1632)
WB_GATE_DB = 60.0          # the reference's gate (bench.py wbfm gate)
K10_TOL = 2e-5             # K10/K12 vs plain: FMA vs separate roundings
# (tile, seg_group) of K10/K12 blocks, the default first
WB_GEOMS = ((2040, 4), (1920, 4), (1020, 4), (1360, 4), (4080, 2), (2040, 2),
            (2040, 8), (1020, 8), (4080, 1), (8160, 1), (680, 8), (1020, 2))


def wb_plan():
    from newsched_tpu_torch.ops import firdes, nco
    from newsched_tpu_torch.ops.cuda import wbfm_chain

    chan = firdes.low_pass(1.0, WB_FS, 100e3, 30e3)
    rt = firdes.low_pass(1.0, 1.0, 0.45 / WB_RD, 0.1 / WB_RD)
    plan = wbfm_chain.WbfmChainPlan(
        chan, nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rt, WB_RD,
        (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    return plan, wbfm_chain.wbfm_consts(plan, "cuda"), chan, rt


def phase_k8_k11(torch, sources) -> dict:
    """K8 and K11 at the main path's shapes against their plain versions,
    on a tone with a nonzero phase and on phases a hair below a turn."""
    from newsched_tpu_torch.ops import nco

    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    errs = {}
    for ph0, dphase, what in ((0x89ABCDEF, dp, "tone"),
                              (0xFFFFFFFF, 0xFFFFFFFF, "quadrant 4")):
        got = sources.nco_planes(ph0, dphase, 0.8, WB_BATCH, "cuda")
        ref = sources.nco_planes_plain(ph0, dphase, 0.8, WB_BATCH, "cuda")
        fgot = sources.nco_folded(ph0, dphase, 0.8, WB_R, "cuda")
        fref = sources.nco_folded_plain(ph0, dphase, 0.8, WB_R, "cuda")
        e8 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        e11 = float((fgot - fref).abs().max())
        log(f"K8 nco_planes ({WB_BATCH} samples = {WB_BATCH // 128} x 128 x 2), "
            f"K11 nco_folded ({WB_R} x 128), {what}: max abs err vs plain "
            f"{e8:.3e} / {e11:.3e} (bit-equal required)")
        require(all(torch.equal(g, r) for g, r in zip(got, ref))
                and torch.equal(fgot, fref), f"K8/K11 {what}: differ from plain")
        if what == "quadrant 4":
            # phases 2^32 - 1 - k: t = -(k+1)/2^32, cos ~ 1 and sin ~ 0-
            require(bool((got[0] > 0.79).all()) and bool((got[1] <= 0).all())
                    and float(got[1][:4096].abs().max()) < 1e-5,
                    "K8: phases below a whole turn left quadrant 0")
        errs["K8"] = max(errs.get("K8", 0.0), e8)
        errs["K11"] = max(errs.get("K11", 0.0), e11)
    return errs


def fm_signal(n: int, torch) -> torch.Tensor:
    """A broadcast-FM signal at the channel's centre: a 2 kHz tone at
    75 kHz deviation, complex64 on the GPU."""
    t = torch.arange(n, dtype=torch.float64, device="cuda") / WB_FS
    msg = torch.sin(2 * np.pi * 2000.0 * t)
    ph = torch.cumsum(2 * np.pi * (WB_DEV / WB_FS) * msg, 0) + 2 * np.pi * WB_FC * t
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def phase_k10(torch, wbfm_chain) -> float:
    """K10 against its plain version on two carried batches, bit-identical
    across tiles, segment groups and a batch split."""
    plan, consts, _, _ = wb_plan()
    x = fm_signal(2 * WB_BATCH, torch)

    def run(step, sizes=(WB_BATCH, WB_BATCH), **kw):
        carry = torch.zeros(plan.B8, 128, device="cuda")
        outs, pos = [], 0
        for n in sizes:
            xp = wbfm_chain.fold_planes(x[pos:pos + n])
            aud, carry = step(xp, carry, plan, consts, **kw)
            outs.append(wbfm_chain.unfold_audio(aud))
            pos += n
        return torch.cat(outs), carry

    got, carry = run(wbfm_chain.wbfm_chain_step)
    ref, carry_p = run(wbfm_chain.wbfm_chain_step_plain)
    err = float((got - ref).abs().max())
    log(f"K10 wbfm_chain_step: 2 carried batches x {WB_R} x 128 rows on an FM "
        f"signal, max abs err vs plain {err:.3e} of max|audio| "
        f"{float(ref.abs().max()):.3f} (tol {K10_TOL}); carry equal: "
        f"{torch.equal(carry, carry_p)}")
    require(err <= K10_TOL and torch.equal(carry, carry_p),
            "K10: kernel disagrees with its plain version")
    for tile, gs in WB_GEOMS[1:]:
        other, _ = run(wbfm_chain.wbfm_chain_step, tile=tile, seg_group=gs)
        require(torch.equal(got, other),
                f"K10: tile {tile} / seg_group {gs} differs from the default")
    one, _ = run(wbfm_chain.wbfm_chain_step, sizes=(2 * WB_BATCH,))
    require(torch.equal(got, one),
            "K10: one batch of 2B differs from two carried batches of B")
    log(f"K10: tiles/segment groups {WB_GEOMS} and one batch of 2B give "
        f"bit-identical audio")
    return err


def live_batches(torch, sources, wbfm_chain, step_live: bool, plain=False):
    """Two carried batches of the live chain from stream start: K12 (or
    its plain version), or K11 -> K10."""
    from newsched_tpu_torch.ops import nco

    plan, consts, _, _ = wb_plan()
    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    carry = torch.zeros(plan.B8, 128, device="cuda")
    outs, ph = [], 0x12345678
    for b in range(2):
        if step_live:
            fn = (wbfm_chain.wbfm_chain_live_step_plain if plain
                  else wbfm_chain.wbfm_chain_live_step)
            outs.append(fn(ph, dp, 0.8, b == 0, plan, consts, WB_R))
        else:
            xp = sources.nco_folded(ph, dp, 0.8, WB_R, "cuda")
            aud, carry = wbfm_chain.wbfm_chain_step(xp, carry, plan, consts)
            outs.append(aud)
        ph = nco.nco_advance(ph, dp, WB_BATCH)
    return outs


def phase_k12(torch, sources, wbfm_chain) -> float:
    got = live_batches(torch, sources, wbfm_chain, True)
    two = live_batches(torch, sources, wbfm_chain, False)
    require(all(torch.equal(a, b) for a, b in zip(got, two)),
            "K12: differs from K11 -> K10")
    plain = live_batches(torch, sources, wbfm_chain, True, plain=True)
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    log(f"K12 wbfm_chain_live_step: 2 carried batches from stream start "
        f"(pre-stream zeros, then the uint32 wrap): bit-equal to K11 -> K10; "
        f"max abs err vs plain {err:.3e} (tol {K10_TOL})")
    require(err <= K10_TOL, "K12: kernel disagrees with its plain version")
    return err


def wb_graph(kind: str, n_batches, sink="vector", tone=WB_TONE,
             center=WB_FC):
    """models.wbfm_receiver at config #1 on the fixed-point tone at WB_TONE:
    staged, fused (cf32 sig_source), folded (sig_source_folded) or live."""
    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import analog

    src = {"staged": None, "fused": None, "live": "live",
           "folded": analog.sig_source_folded(WB_FS, frequency=tone)}[kind]
    if src is None:
        src = analog.sig_source(WB_FS, "complex", frequency=tone)
    fg, blks = models.wbfm_receiver(
        fs=WB_FS, center_freq=center, quad_rate_decim=WB_D,
        audio_decim=(1, WB_RD), deviation=WB_DEV, source=src,
        batch_size=WB_BATCH, sink=sink, fused=kind != "staged",
        n_samples=None if n_batches is None else n_batches * WB_NAUD * 64)
    if kind == "live":
        blks["source"].set_frequency(tone)
    return fg, blks


def phase_wbfm_graphs(torch, sources, wbfm_chain) -> dict:
    """The four config #1 graphs, 4 batches each, against the float64
    golden; each path's launch counts."""
    from newsched_tpu_torch.ops import nco
    from newsched_tpu_torch.testing import fxpt_tone, snr_db, wbfm_golden

    _, _, chan, rt = wb_plan()
    n = 4 * WB_BATCH
    ref = wbfm_golden(fxpt_tone(n, nco.freq_to_dphase(WB_TONE, WB_FS)), chan,
                      nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rt, WB_RD,
                      (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    kernels = {"K8": sources.nco_planes, "K11": sources.nco_folded,
               "K10": wbfm_chain.wbfm_chain_step,
               "K12": wbfm_chain.wbfm_chain_live_step}
    want = {"staged": ("K8",), "fused": ("K8", "K10"),
            "folded": ("K11", "K10"), "live": ("K12",)}
    out, launches, audio = {}, {}, {}
    for kind in ("staged", "fused", "folded", "live"):
        fg, blks = wb_graph(kind, 4)
        for k in kernels.values():
            k.launches = 0
        fg.run(device="cuda")
        counts = {name: k.launches for name, k in kernels.items()}
        got = blks["sink"].data()
        require(got.shape == (n // 20,) and bool(np.isfinite(got).all()),
                f"wbfm {kind}: audio shape {got.shape} or non-finite")
        snr = snr_db(ref[:len(got)], got)
        log(f"wbfm {kind} flowgraph: {len(got)} audio samples, SNR vs float64 "
            f"golden {snr:.2f} dB (gate {WB_GATE_DB} dB); launches {counts}")
        require(snr >= WB_GATE_DB, f"wbfm {kind}: SNR {snr:.2f} dB < gate")
        require(all(counts[k] > 0 for k in want[kind]),
                f"wbfm {kind}: a kernel of the path was never launched")
        out[kind] = snr
        launches[kind] = counts
        audio[kind] = got
    return {"snr": out, "launches": launches, "audio": audio, "ref": ref}


def wb_step_rate(torch, kind: str, card: str) -> float:
    fg, _ = wb_graph(kind, None, sink="null")
    return fg_step_rate(torch, fg, f"wbfm {kind}", card, WB_BATCH)


# -- config #0: the FIR chain, and K3's pipelined form -----------------------

FIR_FS, FIR_FREQ, FIR_NTAPS = 1e6, 123_456.0, 128
FIR_BATCH = 1 << 21        # samples per batch
FIR_R = FIR_BATCH // 64    # folded rows per batch (32768)
FIR_N = 10_000_000         # the reference's gate as written (tests/test_models.py)
FIR_GATE_DB = 60.0         # the reference's gate (bench.py config #0)
K9_TOL = 2e-5              # K9 vs plain, relative to max|out|: FMA, another order
# (tile, seg_group) of K9 blocks, the default first
K9_GEOMS = ((512, 4), (256, 4), (1024, 4), (512, 8), (1024, 16), (2048, 32),
            (256, 2))
K3P_GS = (1, 2, 4)         # tiles a K3p block walks, beside its default


def fir_taps(torch):
    from newsched_tpu_torch.ops import firdes

    taps = firdes.low_pass(1.0, FIR_FS, 0.2 * FIR_FS, 0.05 * FIR_FS,
                           ntaps=FIR_NTAPS)
    return taps, torch.from_numpy(taps.astype(np.float32)).cuda()


def k9_run(torch, fir_source, step, D, sizes=(FIR_BATCH, FIR_BATCH),
           ph=0, first=True):
    """Consecutive batches of the live filtered tone from phase ``ph``
    through ``step`` (K9, its plain version, or K9 at a geometry): the
    unfolded cf32 stream."""
    from newsched_tpu_torch.ops import nco

    _, taps = fir_taps(torch)
    dp = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    outs = []
    for n in sizes:
        outs.append(fir_source.unfold_complex(
            step(ph, dp, 0.8, first, taps, D, n // 64)))
        ph, first = nco.nco_advance(ph, dp, n), False
    return torch.cat(outs)


def k9_at(fir_source, tile: int, gs: int):
    """K9 at a block geometry (tile rows, segments a block)."""
    def step(ph, dp, amp, first, taps, D, R):
        g = fir_source._geometry(R, D, FIR_NTAPS, tile, gs)
        return fir_source._launch(ph, dp, amp, first, taps, D, R, g)
    return step


def phase_k9(torch, fir_source) -> float:
    """K9 at 2^21 samples against its plain version (D = 1 and 4, two
    batches from stream start and one from a nonzero phase), bit-identical
    across block geometries and across a batch split."""
    worst = 0.0
    for D in (1, 4):
        for ph, first, nb in ((0, True, 2), (0x9E3779B9, False, 1)):
            sizes = (FIR_BATCH,) * nb
            got = k9_run(torch, fir_source, fir_source.fir_tone_step, D, sizes,
                         ph, first)
            ref = k9_run(torch, fir_source, fir_source.fir_tone_step_plain, D,
                         sizes, ph, first)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            log(f"K9 fir_tone_step D={D}, {nb} batch(es) of {FIR_BATCH} from "
                f"phase {ph:#x}{' (stream start)' if first else ''}: max abs "
                f"err vs plain {err:.3e} = {err / scale:.3e} of max|out| "
                f"{scale:.4f} (tol {K9_TOL})")
            require(err <= K9_TOL * scale and got.shape == ref.shape,
                    f"K9 D={D}: kernel disagrees with its plain version")
            worst = max(worst, err)
    base = k9_run(torch, fir_source, fir_source.fir_tone_step, 1)
    for tile, gs in K9_GEOMS[1:]:
        require(torch.equal(base, k9_run(torch, fir_source,
                                         k9_at(fir_source, tile, gs), 1)),
                f"K9: tile {tile} / seg_group {gs} differs from the default")
    half = k9_run(torch, fir_source, fir_source.fir_tone_step, 1,
                  (FIR_BATCH // 2,) * 4)
    require(torch.equal(base, half),
            "K9: four batches of 2^20 differ from two batches of 2^21")
    log(f"K9: geometries {K9_GEOMS} and batches of 2^20 give bit-identical "
        f"output")
    return worst


def fir_graph(kind: str, n, sink="vector"):
    from newsched_tpu_torch import models

    return models.fir_chain(n_samples=n, fs=FIR_FS, ntaps=FIR_NTAPS,
                            frequency=FIR_FREQ, batch_size=FIR_BATCH, sink=sink,
                            source="live" if kind == "live" else None)


def phase_fir_graphs(torch, sources, fir_source) -> dict:
    """Config #0 staged (K8 -> fir_filter -> head) and live (K9 -> head) at
    10M samples in batches of 2^21 (the last cut by the head), against the
    float64 golden and each other; each path's launch counts."""
    from newsched_tpu_torch.testing import fir_golden, snr_db

    taps, _ = fir_taps(torch)
    ref = fir_golden(FIR_N, taps, FIR_FREQ, FIR_FS)
    kernels = {"K8": sources.nco_planes, "K9": fir_source.fir_tone_step}
    want = {"staged": "K8", "live": "K9"}
    out, snr, launches = {}, {}, {}
    for kind in ("staged", "live"):
        fg, blks = fir_graph(kind, FIR_N)
        for k in kernels.values():
            k.launches = 0
        fg.run(device="cuda")
        counts = {name: k.launches for name, k in kernels.items()}
        got = blks["sink"].data()
        require(got.shape == (FIR_N,)
                and bool(np.isfinite(got.view(np.float32)).all()),
                f"fir_chain {kind}: output shape {got.shape} or non-finite")
        snr[kind] = snr_db(ref, got)
        log(f"fir_chain {kind} flowgraph: {FIR_N} samples in batches of "
            f"{FIR_BATCH}, SNR vs float64 golden {snr[kind]:.2f} dB (gate "
            f"{FIR_GATE_DB} dB; the CPU tests hold it above 100); launches "
            f"{counts}")
        require(snr[kind] >= FIR_GATE_DB, f"fir_chain {kind}: SNR below gate")
        require(counts[want[kind]] > 0,
                f"fir_chain {kind}: {want[kind]} was never launched")
        out[kind], launches[kind] = got, counts
    cross = snr_db(out["staged"], out["live"])
    log(f"fir_chain live vs staged: {cross:.2f} dB (> 100 required)")
    require(cross > 100, "fir_chain: live and staged disagree")
    return {"snr": snr, "launches": launches, "out": out, "ref": ref}


def phase_k3p(torch, fm_chain) -> dict:
    """K3p (fm_chain_step_planes(pipelined=True)) on two carried batches of
    the FM band, counted: bit-equal to K3, and bit-identical across tiles
    and tiles per block."""
    consts = chain_consts()
    rows = band_rows(torch)
    k3 = k3_batches(torch, fm_chain, consts, rows, fm_chain.fm_chain_step_planes)
    fm_chain.fm_chain_step_planes.pipe_launches = 0
    got = k3_batches(torch, fm_chain, consts, rows,
                     fm_chain.fm_chain_step_planes, pipelined=True)
    launches = fm_chain.fm_chain_step_planes.pipe_launches
    require(launches > 0, "K3p was never launched by pipelined=True")
    require(all(torch.equal(a, b) for a, b in zip(got, k3)),
            "K3p: audio, prev or tail differ from K3")
    for tile in (128, 64):
        for G in K3P_GS:
            other = k3_batches(torch, fm_chain, consts, rows, fm_chain._pipe,
                               tile=tile, tiles_per_block=G)
            require(all(torch.equal(a, b) for a, b in zip(got, other)),
                    f"K3p: tile {tile}, {G} tiles a block differs")
    other = k3_batches(torch, fm_chain, consts, rows,
                       fm_chain.fm_chain_step_planes, pipelined=True, tile=128)
    require(all(torch.equal(a, b) for a, b in zip(got, other)),
            "K3p: tile 128 differs from the default tile 64")
    err = max(float((g - r).abs().max()) for g, r in zip(
        got, k3_batches(torch, fm_chain, consts, rows,
                        fm_chain.fm_chain_step_planes_plain)))
    log(f"K3p fm_chain_step_planes(pipelined=True): 2 batches x {ROWS} rows, "
        f"bit-equal to K3 (audio, prev, tail), bit-identical at tiles 128/64 "
        f"x {K3P_GS} tiles a block; max abs err vs plain {err:.3e}; "
        f"launches {launches}")
    require(err <= K3_TOL, "K3p: disagrees with the plain version")
    return {"launches": launches, "err": err}


def fir_step_rate(torch, kind: str, card: str) -> float:
    fg, _ = fir_graph(kind, FIR_N, sink="null")
    return fg_step_rate(torch, fg, f"fir_chain {kind}", card, FIR_BATCH)


# -- sharding: logical shards on the one card --------------------------------

MESHES = (4, 8)            # logical shards of the sharded graphs
K6_ROWS = ROWS // 4        # rows of a shard of a 4-shard batch (8192)
K6_NLOC = tuple(ROWS // n for n in MESHES)  # a shard's rows: 8192, 4096
K6_WARM = 512              # the reference's warm at both (its tile)


def phase_k6(torch, fm_chain, noise) -> float:
    """K6 at a shard's rows against K5's stream at the same rows (bit for
    bit) and its plain version (K5_TOL off the branch cut), at the rows of
    a shard of the 4- and the 8-shard live path (the second window a prefix
    of the first). K5 runs one batch of ROWS rows with zero state from 3
    shards below the shard (at stream start for the first): its blocks
    reach 80 rows back at most, so from there on it is the true stream.
    Returns the worst error."""
    consts = chain_consts()
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    worst = 0.0
    for draws in (3, 2):
        for where, base, off in (("stream start", 0, 0),
                                 ("shard 3", 3 * K6_ROWS // 64, 3 * K6_ROWS),
                                 ("group 2^32-2", (1 << 32) - 2, 3 * K6_ROWS)):
            b0 = base - off // noise.GROUP_ROWS
            k5 = fm_chain.fm_chain_gen_step(
                noise.group_tensor(b0, "cuda"), amp,
                torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
                torch.zeros(A - 1, 2 * M, **z), consts, DECIM, DEMOD_GAIN, ROWS,
                draws=draws)[0]
            if b0 == 0:  # phases 7 and 13's goldens of this stream
                _, bad = golden(None, "noise" if draws == 3 else "noise draws=2")
                bad = bad[off // DECIM:]
            else:  # the shard's window and 1024 rows of lead, as far back
                lead = 1024  # as any output reaches (A + L - 1 = 80 rows)
                rows = noise.gaussian_rows_plain(
                    base, n_rows=lead + K6_ROWS, width=2 * M, seed=0,
                    device="cuda", draws=draws, row0=-lead) * 0.5
                _, bad = golden(rows.cpu().numpy(), f"{where} draws={draws}")
                bad = bad[lead // DECIM:]
            for n_loc in K6_NLOC:
                # the base from the card: the batch's counter and the
                # shard's offset in groups, as the sharded source passes it
                got = fm_chain.fm_chain_gen_warm_step(
                    noise.group_tensor(b0, "cuda"), amp, consts, DECIM,
                    DEMOD_GAIN, n_loc, warm=K6_WARM, draws=draws,
                    goff=off // noise.GROUP_ROWS)
                plain = fm_chain.fm_chain_gen_warm_step_plain(
                    base, amp, consts, DECIM, DEMOD_GAIN, n_loc, K6_WARM,
                    draws=draws)
                require(torch.equal(got, k5[off // DECIM:(off + n_loc) // DECIM]),
                        f"K6 at {where}, {n_loc} rows, draws={draws}: differs "
                        f"from K5's stream")
                keep = ~bad[:n_loc // DECIM]
                err = float(np.abs(got.cpu().numpy()
                                   - plain.cpu().numpy())[keep].max())
                log(f"K6 fm_chain_gen_warm_step at {where} (base group "
                    f"{base}), {n_loc} rows, draws={draws}: "
                    f"bit-equal to K5's stream there; vs plain {err:.3e} on "
                    f"{int(keep.sum())} unmasked samples (tol {K5_TOL})")
                require(err <= K5_TOL, f"K6 at {where}, {n_loc} rows: "
                        f"disagrees with its plain version")
                worst = max(worst, err)
    return worst


def phase_sharded_live(fm_chain, live_out: np.ndarray) -> int:
    """The live flowgraph over 4 and 8 shards: bit-equal to the unsharded
    one, gated against its golden; K6 launched n times a batch, K5 never.
    Returns K6's launches."""
    from newsched_tpu_torch.parallel import make_mesh

    total = 0
    for n in MESHES:
        fg, blks = flowgraph("live", 3)
        fm_chain.fm_chain_gen_warm_step.launches = 0
        fm_chain.fm_chain_gen_step.launches = 0
        fg.run(device="cuda", mesh=make_mesh(n))
        k6, k5 = (fm_chain.fm_chain_gen_warm_step.launches,
                  fm_chain.fm_chain_gen_step.launches)
        got = blks["sink"].data()
        log(f"launches on the live path, {n} shards: fm_chain_gen_warm_step "
            f"{k6}, fm_chain_gen_step {k5}")
        require(k6 == 3 * n and k5 == 0,
                f"live on {n} shards: K6 not n times a batch, or K5 ran")
        require(np.array_equal(got, live_out[:3 * N_AUD]),
                f"live on {n} shards differs from the unsharded flowgraph")
        gate(None, got, f"live flowgraph on {n} shards (bit-equal to the "
             f"unsharded one)", "noise", n_batches=3)
        total += k6
    return total


def phase_sharded_fused(torch, fm_chain, rows: np.ndarray,
                        replay_out: np.ndarray) -> tuple[int, float]:
    """The fused flowgraph over the replayed stream on 4 and 8 shards:
    bit-equal to the unsharded one, gated; K3 launched n times a batch.
    Then, on shard 1 of each mesh, K3 with warm > 0 against its plain
    version (K3_TOL off the branch cut) and the unsharded stream, and K3p
    with warm > 0 against K3. Returns K3's launches with warm > 0 and the
    worst error against the plain version."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    total = 0
    for n in MESHES:
        fg, blks = flowgraph(general.vector_source(rows, repeat=True), 3)
        fm_chain.fm_chain_step_planes.launches = 0
        fg.run(device="cuda", mesh=make_mesh(n))
        k3 = fm_chain.fm_chain_step_planes.launches
        got = blks["sink"].data()
        log(f"launches on the fused path, {n} shards: fm_chain_step_planes {k3}")
        require(k3 == 3 * n, f"fused on {n} shards: K3 not n times a batch")
        require(np.array_equal(got, replay_out[:3 * N_AUD]),
                f"fused on {n} shards differs from the unsharded flowgraph")
        gate(np.concatenate([rows] * 4), got, f"fused flowgraph on {n} shards "
             f"(bit-equal to the unsharded one)", "replay", n_batches=3)
        total += k3
    H8 = fm_chain._round8(L - 1)
    consts = chain_consts()
    vb_all = torch.from_numpy(rows).cuda()
    z = dict(dtype=torch.float32, device="cuda")
    hr = K6_WARM + H8
    _, bad = golden(None, "replay")
    worst = 0.0
    for n_dev, n_loc in zip(MESHES, K6_NLOC):
        args = (vb_all[n_loc:2 * n_loc], vb_all[n_loc - hr:n_loc],
                torch.zeros(1, 2 * M, **z), torch.zeros(A - 1, 2 * M, **z),
                consts, DECIM, DEMOD_GAIN)
        shard = fm_chain.fm_chain_step_planes(*args, warm=K6_WARM)
        plain = fm_chain.fm_chain_step_planes_plain(*args, warm=K6_WARM)
        piped = fm_chain.fm_chain_step_planes(*args, warm=K6_WARM,
                                              pipelined=True)
        sl = slice(n_loc // DECIM, 2 * n_loc // DECIM)
        require(all(torch.equal(a, b) for a, b in zip(shard, piped)),
                f"K3p with warm > 0 differs from K3 ({n_loc} rows)")
        require(np.array_equal(shard[0].cpu().numpy(), replay_out[sl]),
                f"K3 with warm > 0 differs from the unsharded stream "
                f"({n_loc} rows)")
        keep = ~bad[sl]
        err = float(np.abs(shard[0].cpu().numpy()
                           - plain[0].cpu().numpy())[keep].max())
        log(f"K3 with warm={K6_WARM} on shard 1 of {n_dev} ({n_loc} rows): "
            f"vs plain {err:.3e} on {int(keep.sum())} unmasked samples (tol "
            f"{K3_TOL}); K3p bit-equal to it, both bit-equal to the "
            f"unsharded stream")
        require(err <= K3_TOL, f"K3 with warm > 0 ({n_loc} rows): disagrees "
                f"with its plain version")
        worst = max(worst, err)
    return total, worst


def shard_kernels_vs_plain(torch, wbfm_chain, fir_source, n: int) -> dict:
    """Shards 0 and 1 of an n-shard batch through K10, K12 and K9 as the
    sharded blocks call them (K10 from a zero carry, then from shard 0's
    boundary rows; K12 and K9 at each shard's phase offset, stream start
    on shard 0 only), each against its plain version: K10_TOL (carry
    equal), K10_TOL, K9_TOL of max|out|. Returns each kernel's worst
    error."""
    from newsched_tpu_torch.ops import nco

    plan, consts, _, _ = wb_plan()
    seg = WB_BATCH // n
    x = fm_signal(2 * seg, torch)
    dp = nco.freq_to_dphase(WB_TONE, WB_FS)
    _, taps = fir_taps(torch)
    seg9, dp9 = FIR_BATCH // n, nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    carry = torch.zeros(plan.B8, 128, device="cuda")
    errs = {"K10": 0.0, "K12": 0.0, "K9": 0.0}
    for d in range(2):
        xp = wbfm_chain.fold_planes(x[d * seg:(d + 1) * seg])
        aud, bot = wbfm_chain.wbfm_chain_step(xp, carry, plan, consts)
        ref, bot_p = wbfm_chain.wbfm_chain_step_plain(xp, carry, plan, consts)
        require(torch.equal(bot, bot_p), f"K10 shard {d} of {n}: carry differs "
                f"from its plain version's")
        errs["K10"] = max(errs["K10"], float((aud - ref).abs().max()))
        carry = bot
        ph, first = nco.nco_advance(0x12345678, dp, seg * d), d == 0
        got = wbfm_chain.wbfm_chain_live_step(ph, dp, 0.8, first, plan, consts,
                                              seg // 64)
        ref = wbfm_chain.wbfm_chain_live_step_plain(ph, dp, 0.8, first, plan,
                                                    consts, seg // 64)
        errs["K12"] = max(errs["K12"], float((got - ref).abs().max()))
        ph = nco.nco_advance(0, dp9, seg9 * d)
        got = fir_source.fir_tone_step(ph, dp9, 0.8, first, taps, 1, seg9 // 64)
        ref = fir_source.fir_tone_step_plain(ph, dp9, 0.8, first, taps, 1,
                                             seg9 // 64)
        err = float((got - ref).abs().max())
        require(err <= K9_TOL * float(ref.abs().max()),
                f"K9 shard {d} of {n}: disagrees with its plain version")
        errs["K9"] = max(errs["K9"], err)
    log(f"shards 0-1 of {n}: K10 ({seg // 64} rows), K12 ({seg // 64} rows), "
        f"K9 ({seg9 // 64} rows) vs plain: max abs err {errs['K10']:.3e}, "
        f"{errs['K12']:.3e}, {errs['K9']:.3e} (tol {K10_TOL}, {K10_TOL}, "
        f"{K9_TOL} of max|out|)")
    require(errs["K10"] <= K10_TOL and errs["K12"] <= K10_TOL,
            f"K10/K12 on a shard of {n}: disagree with their plain versions")
    return errs


def phase_sharded_receivers(torch, sources, wbfm_chain, fir_source, wb: dict,
                            fir: dict) -> tuple[dict, dict]:
    """The wbfm fused (sig_source K8 -> K10 per shard) and live (K12) graphs
    and the live fir_chain (K9) on 4 and 8 shards, 3 batches: bit-equal to
    their unsharded graphs, >= 60 dB; launches counted. Then one shard's
    K10, K12 and K9 call of each mesh against its plain version. Returns
    the launches and each kernel's worst error."""
    from newsched_tpu_torch.parallel import make_mesh
    from newsched_tpu_torch.testing import snr_db

    kernels = {"K8": sources.nco_planes, "K10": wbfm_chain.wbfm_chain_step,
               "K12": wbfm_chain.wbfm_chain_live_step,
               "K9": fir_source.fir_tone_step}
    launches: dict = {}
    for n in MESHES:
        for kind in ("wbfm fused", "wbfm live", "fir_chain live"):
            if kind.startswith("wbfm"):
                form = kind.split()[1]
                fg, blks = wb_graph(form, 3)
                unsharded, ref, gate_db = wb["audio"][form], wb["ref"], WB_GATE_DB
                want = ({"K8": 3, "K10": 3 * n} if form == "fused"
                        else {"K12": 3 * n})
            else:
                fg, blks = fir_graph("live", 3 * FIR_BATCH)
                unsharded, ref = fir["out"]["live"], fir["ref"]
                gate_db, want = FIR_GATE_DB, {"K9": 3 * n}
            for k in kernels.values():
                k.launches = 0
            fg.run(device="cuda", mesh=make_mesh(n))
            counts = {name: k.launches for name, k in kernels.items()}
            got = blks["sink"].data()
            snr = snr_db(ref[:len(got)], got)
            log(f"{kind} flowgraph on {n} shards: {len(got)} samples, "
                f"bit-equal to the unsharded one; SNR vs float64 golden "
                f"{snr:.2f} dB (gate {gate_db} dB); launches {counts}")
            require(len(got) > 0 and np.array_equal(got, unsharded[:len(got)]),
                    f"{kind} on {n} shards differs from the unsharded graph")
            require(snr >= gate_db, f"{kind} on {n} shards: SNR below gate")
            require(all(counts[k] == v for k, v in want.items()),
                    f"{kind} on {n} shards: launches {counts}, want {want}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    errs: dict = {}
    for n in MESHES:
        for k, e in shard_kernels_vs_plain(torch, wbfm_chain, fir_source,
                                           n).items():
            errs[k] = max(errs.get(k, 0.0), e)
    return launches, errs


# -- graph mode: the runner's captured chunks against its loop ---------------

def launch_counts() -> dict:
    """Every kernel's launch count on the flowgraph paths, by name."""
    from newsched_tpu_torch.ops.cuda import launch_counters

    return {f"{f.__name__}.{a}": getattr(f, a) for f, a in launch_counters()}


def zero_launches() -> None:
    from newsched_tpu_torch.ops.cuda import launch_counters

    for f, a in launch_counters():
        setattr(f, a, 0)


def graph_vs_loop(build, label: str, want, mesh=None):
    """A graph of 2C + 1 batches (C = GRAPH_CHUNK: two replays of the
    captured chunk and a remainder) run by fg.run() on the card, which
    takes graph mode, and by Runner._run_loop: bit-equal, with the same
    launch counts, each kernel of ``want`` among them. Returns the graph
    mode's output and counts."""
    from newsched_tpu_torch.runtime import runner as rt

    nb = 2 * rt.GRAPH_CHUNK + 1
    out, counts = {}, {}
    for mode in ("graph", "loop"):
        fg, blks = build(nb)
        zero_launches()
        if mode == "graph":
            r = fg.run(device="cuda", mesh=mesh)
            require(r._chunk is not None and r._chunk.graph is not None,
                    f"{label}: fg.run() did not capture a graph")
        else:
            fg.validate()
            r = rt.Runner(fg, device="cuda", batch_size=fg.batch_size,
                          mesh=mesh)
            r._run_loop(r.cfg.n_batches)
        require(r.cfg.n_batches == nb, f"{label}: {r.cfg.n_batches} batches")
        counts[mode] = {k: v for k, v in launch_counts().items() if v}
        out[mode] = blks["sink"].data()
    log(f"graph mode, {label}: {nb} batches (chunks of {rt.GRAPH_CHUNK} "
        f"replayed twice, {nb % rt.GRAPH_CHUNK} stepped), bit-equal to the "
        f"loop: {np.array_equal(out['graph'], out['loop'])}; launches "
        f"{counts['graph']}")
    require(out["graph"].shape == out["loop"].shape
            and np.array_equal(out["graph"], out["loop"]),
            f"{label}: graph mode differs from the loop")
    require(counts["graph"] == counts["loop"],
            f"{label}: graph-mode launches {counts['graph']} != loop's "
            f"{counts['loop']}")
    require(all(counts["graph"].get(k, 0) > 0 for k in want),
            f"{label}: a kernel of the path ({want}) was never launched")
    return out["graph"], counts["graph"]


def phase_graph_mode(rows: np.ndarray, wb: dict, fir: dict) -> dict:
    """30. Every unsharded graph and the 4-shard live and fused graphs in
    graph mode against the loop, bit for bit, and above their gates on
    the batches the goldens cover; returns each path's launches."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh
    from newsched_tpu_torch.testing import snr_db

    K3, K4 = "fm_chain_step_planes.launches", "gaussian_rows.launches"
    K1, K5 = "arm_fold_dft.launches", "fm_chain_gen_step.launches"
    K6 = "fm_chain_gen_warm_step.launches"
    K8, K11 = "nco_planes.launches", "nco_folded.launches"
    K10, K12 = "wbfm_chain_step.launches", "wbfm_chain_live_step.launches"
    K9 = "fir_tone_step.launches"
    launches, outs = {}, {}
    replay = lambda nb: flowgraph(general.vector_source(rows, repeat=True), nb)
    for label, build, want, key, gate_db in (
            ("#2 fused replay", replay, (K3,), "replay", SNR_GATE_DB),
            ("#2 fused noise", lambda nb: flowgraph(None, nb), (K3, K4),
             "noise", SNR_GATE_DB),
            ("#2 staged", lambda nb: flowgraph(None, nb, fused=False),
             (K1, K4), "staged", STAGED_GATE_DB),
            ("#2 live", lambda nb: flowgraph("live", nb), (K5,), "noise",
             SNR_GATE_DB)):
        got, launches[label] = graph_vs_loop(build, label, want)
        gate(None, got[:4 * N_AUD], f"{label} in graph mode", key, gate_db,
             n_batches=4)
        outs[label] = got
    require(np.array_equal(outs["#2 live"], outs["#2 fused noise"]),
            "graph mode: live differs from the fused noise graph")
    for label, build, want, ref in (
            ("#2 live, 4 shards", lambda nb: flowgraph("live", nb), (K6,),
             outs["#2 live"]),
            ("#2 fused replay, 4 shards", replay, (K3,),
             outs["#2 fused replay"])):
        got, launches[label] = graph_vs_loop(build, label, want, make_mesh(4))
        require(np.array_equal(got, ref),
                f"{label}: differs from the unsharded graph mode")
    for kind, want in (("staged", (K8,)), ("fused", (K8, K10)),
                       ("folded", (K11, K10)), ("live", (K12,))):
        label = f"#1 {kind}"
        got, launches[label] = graph_vs_loop(
            lambda nb, kind=kind: wb_graph(kind, nb), label, want)
        n = 4 * WB_BATCH // 20
        snr = snr_db(wb["ref"][:n], got[:n])
        log(f"{label} in graph mode: SNR vs float64 golden {snr:.2f} dB on "
            f"the first 4 batches (gate {WB_GATE_DB})")
        require(snr >= WB_GATE_DB, f"{label}: below the gate")
    for kind, want in (("staged", (K8,)), ("live", (K9,))):
        label = f"#0 {kind}"
        got, launches[label] = graph_vs_loop(
            lambda nb, kind=kind: fir_graph(kind, nb * FIR_BATCH), label, want)
        snr = snr_db(fir["ref"], got[:FIR_N])
        log(f"{label} in graph mode: SNR vs float64 golden {snr:.2f} dB on "
            f"{FIR_N} samples (gate {FIR_GATE_DB})")
        require(snr >= FIR_GATE_DB, f"{label}: below the gate")
    return launches


def phase_params() -> None:
    """31. Parameter changes under graph mode: a new tone (dphase, copied
    into its tensor in place) between two runs of one runner, in the fused
    receiver's sig_source and in the live receiver, keeps the captured
    chunk and equals a fresh runner's output; a new center_freq (a fence)
    captures anew and equals a fresh runner's."""
    from newsched_tpu_torch.runtime import runner as rt

    nb = rt.GRAPH_CHUNK + 1
    tone2, center2 = 187_500.0, 210e3
    for kind in ("fused", "live"):
        fg, blks = wb_graph(kind, nb)
        r = fg.run(device="cuda")
        chunk, before = r._chunk, blks["sink"].data().copy()
        blks["source"].set_frequency(tone2)
        r.run_to_completion()
        fg2, blks2 = wb_graph(kind, nb, tone=tone2)
        fg2.run(device="cuda")
        require(r._chunk is chunk and chunk.graph is not None,
                f"{kind}: a dphase change captured anew")
        require(np.array_equal(blks["sink"].data(), blks2["sink"].data())
                and not np.array_equal(before, blks["sink"].data()),
                f"{kind}: the new dphase did not take effect in graph mode")
        log(f"graph mode, wbfm {kind}: a dphase change between runs kept "
            f"the chunk and equals a fresh runner's output")
    fg, blks = wb_graph("fused", nb)
    r = fg.run(device="cuda")
    chunk = r._chunk
    blks["fused"].set_param("center_freq", center2)
    r.run_to_completion()
    fg2, blks2 = wb_graph("fused", nb, center=center2)
    fg2.run(device="cuda")
    require(r._chunk is not chunk and r._chunk.graph is not None,
            "center_freq: no new capture")
    require(np.array_equal(blks["sink"].data(), blks2["sink"].data()),
            "center_freq: graph mode differs from a fresh runner")
    log("graph mode, wbfm fused: a center_freq change captured anew and "
        "equals a fresh runner's output")


def phase_counters(torch, fm_chain, noise) -> None:
    """32. K4 and K5 started from the sources' counter on the card at group
    2^32-2 and at a negative group: K4 bit-equal to its plain version at
    the same base (mask_pre off and on), K5 bit-equal to K4 -> K3 and its
    carry (the generated rows) to its plain version's."""
    consts = chain_consts()
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    for base in ((1 << 32) - 2, -3):
        g = noise.group_tensor(base, "cuda")
        for mask in (False, True):
            got = noise.gaussian_rows(g, n_rows=ROWS, width=2 * M, seed=0,
                                      device="cuda", mask_pre=mask)
            ref = noise.gaussian_rows_plain(base, n_rows=ROWS, width=2 * M,
                                            seed=0, device="cuda",
                                            mask_pre=mask)
            require(torch.equal(got, ref), f"K4 at group {base}, mask_pre "
                    f"{mask}: differs from its plain version")
        k5 = fm_chain.fm_chain_gen_step(g, amp, *st, consts, DECIM, DEMOD_GAIN,
                                        ROWS)
        k4k3 = composed(noise.gaussian_rows, fm_chain.fm_chain_step_planes)(
            g, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS, draws=3)
        plain = fm_chain.fm_chain_gen_step_plain(base, amp, *st, consts, DECIM,
                                                 DEMOD_GAIN, ROWS)
        require(all(torch.equal(a, b) for a, b in zip(k5, k4k3)),
                f"K5 at group {base}: differs from K4 -> K3")
        require(torch.equal(k5[3], plain[3]),
                f"K5 at group {base}: its rows differ from the plain version's")
        nxt = noise.advance(g, ROWS // noise.GROUP_ROWS)
        require(int(nxt) == noise._i64(base + ROWS // noise.GROUP_ROWS),
                f"the counter's advance from {base} on the card")
        log(f"on-card counter at group {base}: K4 bit-equal to plain (mask_pre "
            f"off and on), K5 bit-equal to K4 -> K3, its rows to plain")


def phase_probes(torch, fm_chain) -> dict:
    """33. The probes against their plain versions: window_copy in every
    variant exactly, planes_unpack bit-equal to cplx_to_planes over two
    batches, the ablation's "full" bit-equal to K3 and every variant within
    K3_TOL of max(1, max|out|) of its plain version on the FM band."""
    from newsched_tpu_torch.blocks import vector_dsp
    from newsched_tpu_torch.probes import ablate, dma, prep, run

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(run.ROWS + run.H8, 128, device="cuda", generator=g)
    cases = [("dbuf", T, x, None, run.H8) for T in run.DMA_TILES]
    cases += [("single", T, x, None, run.H8) for T in run.DMA_TILES]
    xr, xi = (torch.randn(run.ROWS + run.H8, 64, device="cuda", generator=g)
              for _ in range(2))
    cases += [("split", T, xr, xi, run.H8) for T in (64, run.K3_TILE)]
    for W in dma.LANES["dbuf"]:
        cases.append(("dbuf", 16384 // W, torch.randn(
            run.NTOT // W, W, device="cuda", generator=g), None, 0))
    x5 = torch.randn(run.NTOT // 512, 512, device="cuda", generator=g)
    cases += [("direct", T, x5, None, 0) for T in (512, 32)]
    for variant, T, xx, xxi, H in cases:
        got = dma.window_copy(xx, T, H, variant=variant, xi=xxi)
        require(torch.equal(got, dma.window_copy_plain(xx, T, H, xxi)),
                f"window_copy {variant} tile {T} x {xx.shape[1]}: differs "
                f"from its plain version")
    log(f"window_copy: {len(cases)} variants and tiles exactly equal to the "
        f"plain strided slice, every tile's slot checked")
    xs = torch.from_numpy(fm_band(2 * BATCH, "cuda")).cuda()
    skew = torch.zeros(M - 1, dtype=torch.complex64, device="cuda")
    blk = vector_dsp.cplx_to_planes(M)
    bst = blk.init_state(BATCH, ROWS, "cuda")
    for b in range(2):
        xb = xs[b * BATCH:(b + 1) * BATCH]
        got, skew = prep.planes_unpack(xb, skew)
        bst, ref = blk.work(bst, {"in": xb}, {}, ROWS)
        require(torch.equal(got, ref["out"]) and torch.equal(skew, bst["skew"]),
                f"planes_unpack batch {b}: differs from cplx_to_planes")
    log("planes_unpack: two carried batches bit-equal to cplx_to_planes")
    consts = chain_consts()
    rows = band_rows(torch)[:ROWS]
    H8 = fm_chain._round8(L - 1)
    z = dict(dtype=torch.float32, device="cuda")
    st = (torch.zeros(H8, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    k3 = fm_chain.fm_chain_step_planes(rows, *st, consts, DECIM, DEMOD_GAIN)
    full = ablate.fm_chain_ablate(rows, *st, consts, DECIM, DEMOD_GAIN)
    require(all(torch.equal(a, b) for a, b in zip(full, k3)),
            "ablation full: differs from K3")
    worst = 0.0
    for v in ablate.VARIANTS:
        got = ablate.fm_chain_ablate(rows, *st, consts, DECIM, DEMOD_GAIN, v)[0]
        ref = ablate.fm_chain_ablate_plain(rows, *st, consts, DECIM,
                                           DEMOD_GAIN, v)[0]
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"ablation {v}: max abs err vs plain {err:.3e} (max|out| "
            f"{scale:.3e}; tol {K3_TOL} x max(1, max|out|))")
        require(err <= K3_TOL * max(1.0, scale),
                f"ablation {v}: disagrees with its plain version")
        worst = max(worst, err)
    return {"window_copy": 0.0, "planes_unpack": 0.0, "ablate": worst}


def graph_cells(rows: np.ndarray) -> dict:
    """Every timed cell as (builder of its graph with a null sink, input
    samples a batch, mesh)."""
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    def ch(source, **kw):
        return lambda: flowgraph(source() if callable(source) else source,
                                 None, sink="null", **kw)[0]

    replay = lambda: general.vector_source(rows, repeat=True)
    cells = {"replay": (ch(replay), BATCH, None),
             "noise source": (ch(None), BATCH, None),
             "staged": (ch(None, fused=False), BATCH, None),
             "live": (ch("live"), BATCH, None)}
    for kind in ("staged", "fused", "folded", "live"):
        cells[f"wbfm {kind}"] = (lambda kind=kind: wb_graph(kind, None,
                                                            "null")[0],
                                 WB_BATCH, None)
    for kind in ("staged", "live"):
        cells[f"fir_chain {kind}"] = (lambda kind=kind: fir_graph(
            kind, FIR_N, sink="null")[0], FIR_BATCH, None)
    for n in MESHES:
        cells[f"live, {n} shards"] = (ch("live"), BATCH, make_mesh(n))
        cells[f"replay, {n} shards"] = (ch(replay), BATCH, make_mesh(n))
    return cells


GRAPH_K = (16, 64)     # the two points of chip_smoke's graph-mode fits
CHUNKS = (2, 4, 8, 16)  # chunk sizes measured for runner.GRAPH_CHUNK


def phase_graph_times(torch, rows: np.ndarray, card: str) -> dict:
    """34a. Each cell's graph-mode step by the bench's two-point fit, beside
    its loop-mode step and its profiled device time (the busy share in
    graph mode); the chunk sizes on a host-bound and a device-bound cell;
    a short run of the bench's timer on its headline path."""
    from newsched_tpu_torch import bench

    out = {}
    for label, (build, n_in, mesh) in graph_cells(rows).items():
        sps = bench.timed_two_point(
            bench.graph_run(build(), "cuda", mesh=mesh), f"graph mode {label}",
            n_in, n_best=3, k1=GRAPH_K[0], k2=GRAPH_K[1])
        ms = n_in / sps * 1e3
        loop_ms, dev_ms = LOOP.get(label, (None, None))
        busy = "not profiled" if dev_ms is None else f"{100 * dev_ms / ms:.0f}%"
        log(f"cell {label}: graph mode {ms:.4f} ms = {n_in / ms / 1e3:.1f} "
            f"Msamples/s; loop {loop_ms if loop_ms is None else round(loop_ms, 4)}"
            f" ms; device {dev_ms if dev_ms is None else round(dev_ms, 4)} ms "
            f"a step; busy in graph mode {busy} [{card}]")
        out[label] = ms
    cells = graph_cells(rows)
    for label in ("wbfm staged", "replay"):
        build, n_in, _ = cells[label]
        for C in CHUNKS:
            sps = bench.timed_two_point(
                bench.graph_run(build(), "cuda", chunk=C),
                f"chunk {C}, {label}", n_in, n_best=3, k1=GRAPH_K[0],
                k2=GRAPH_K[1])
            log(f"graph chunk {C} steps, {label}: {n_in / sps * 1e3:.4f} ms a "
                f"step [{card}]")
    taps, audio_taps = design()
    run_k, gate_audio, brows, B = bench.graph_paths(taps, audio_taps, BATCH,
                                                    "cuda")
    require(np.array_equal(brows, rows), "the bench's batch is not phase 6's")
    ref, bad = golden(None, "replay")  # phase 6's golden, its first batch
    ref, bad = ref[:N_AUD], bad[:N_AUD]
    snr = bench.snr_db(ref[~bad], gate_audio()[~bad])
    require(snr >= bench.GATE_DB, f"the bench's headline gate: {snr:.2f} dB")
    sps = bench.timed_two_point(run_k, "bench headline (K1 = 10, K2 = 40)", B,
                                k1=10, k2=40)
    log(f"bench timer, headline path: {sps / 1e6:.1f} Msamples/s at "
        f"{snr:.2f} dB [{card}]")
    return out


def phase_probe_times(torch, card: str) -> dict:
    """34b. The probes' measurements (the probes' main path, counted):
    GB/s of each window copy beside 3.35 TB/s, the prep pass, the
    ablation beside K3; and each probe kernel's plain and library times."""
    from newsched_tpu_torch.probes import ablate, dma, prep, run
    from newsched_tpu_torch.probes._timing import graph_ms as pgraph_ms

    counters = {"window_copy": dma.window_copy, "planes_unpack":
                prep.planes_unpack, "ablate": ablate.fm_chain_ablate}
    for f in counters.values():
        f.launches = 0
    recs = run.dma_sweep(5) + run.prep_times(5) + run.ablate_times(5)
    launches = {k: f.launches for k, f in counters.items()}
    for r in recs:
        log(f"probe {json.dumps(r)} [{card}]")
    require(all(n > 0 for n in launches.values()),
            f"a probe kernel was never launched: {launches}")
    by = {(r.get("case") or r.get("variant"), r.get("tile")): r for r in recs}
    x = torch.randn(run.ROWS + run.H8, 128, device="cuda")
    xc, skew, _, _, _, _, _ = run.chain_inputs()
    rows_c = xc.view(-1, M)
    t = {"window_copy": by[("dma_dbuf", run.K3_TILE)]["us"] * 1e-3,
         "window_copy plain": median_ms(
             lambda: dma.window_copy_plain(x, run.K3_TILE, run.H8)),
         "window_copy library": by[("torch_clone", None)]["us"] * 1e-3,
         "planes_unpack": by[("planes_unpack", None)]["us"] * 1e-3,
         "planes_unpack plain": median_ms(
             lambda: prep.planes_unpack_plain(xc, skew)),
         "planes_unpack library": pgraph_ms(
             lambda: torch.cat([rows_c.real, rows_c.imag], dim=1), 5),
         "ablate": by[("full", None)]["us"] * 1e-3}
    k3 = by[("K3", None)]["us"]
    for v in ablate.VARIANTS:
        log(f"ablation {v}: {by[(v, None)]['us']:.2f} us, K3 {k3:.2f} us, "
            f"{100 * by[(v, None)]['us'] / k3:.1f}% of K3 [{card}]")
    return {"launches": launches, "t": t, "x_bytes": x.numel() * 4,
            "n_tiles": run.ROWS // run.K3_TILE, "stream_bytes": xc.numel() * 8}


# -- the least time of each kernel's work on the card ------------------------

PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (published)
PEAK_FP32 = 67e12      # FP32 outside the tensor cores, operations/s


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    FP32 peak (the integer work of Philox is counted at the same rate, the
    nearest entry of the published table), in ms, and which one it is."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


ATAN_OPS = 2 * 9 + 10   # degree-9 polynomial in z^2 + reduction and quadrant
DEMOD_OPS = 6 + ATAN_OPS + 1        # conj product, atan2, gain
NCO_OPS = 2 + 2 + 5 + 2 * 2 * 5 + 1 + 4 + 2  # phase, turns, reduce, polys, select, amp
PHILOX_OPS = 10 * 10 + 14           # 10 rounds, Irwin-Hall sum and scale
# an overlap-save FFT convolution at 1024 points and 128 taps: a forward and
# an inverse FFT (2 x 5 N log2 N) and N complex products (6 N) per 897
# outputs, ~121 flops a complex output
FIR_FFT_OPS = 121


def kernel_bounds() -> dict:
    """(bound ms, bound_by) of every kernel at the shapes this run gives it:
    each input read once and each output written once, and the least
    arithmetic of the function (multiply-adds count 2), not of the
    kernel's formulation: an M-point FFT a row (5 M log2 M flops) where
    K1/K3/K5 do a dense (2M x 2M) real DFT product, and for K10/K12 the
    staged order (rotate each input sample by the NCO, then a real-tap FIR)
    where the kernels filter with complex rotated taps, and for K9 an FFT
    convolution where the kernel runs the FIR in direct form."""
    f4 = 4
    n, W = ROWS, 2 * M
    fold = 2 * L * n * W
    fft = 5 * M * int(np.log2(M)) * n
    audio = 2 * A * (n // DECIM) * M
    demod = DEMOD_OPS * n * M
    chain_out = ((n // DECIM) * M + (A - 1) * W + W) * f4
    # K6 at a shard: K5's work at its rows, and the A + L - 1 rows before
    # them that it generates for its junction; only the audio leaves
    r6 = K6_ROWS / n
    k6_ops = (fold + fft + demod + audio) * r6 \
        + PHILOX_OPS * (K6_ROWS + A + L - 1) * W
    U = (WB_R // WB_D) * 64  # xlate outputs
    # real taps on complex samples (4 flops a tap), demod, real resampler
    wb_chain = 4 * 81 * U + DEMOD_OPS * U + 2 * 121 * WB_NAUD * 64
    rotate = (NCO_OPS + 6) * WB_BATCH  # NCO + a complex multiply a sample
    return {
        "K3": bound((n + L) * W * f4 + chain_out, fold + fft + demod + audio),
        "K4": bound(n * W * f4, PHILOX_OPS * n * W),
        "K1": bound((n + L - 1) * W * f4 + n * W * f4, fold + fft),
        "K7": bound((n + L - 1) * W * f4 + n * W * f4, fold),
        "K5": bound(chain_out, fold + fft + demod + audio + PHILOX_OPS * n * W),
        "K6": bound((K6_ROWS // DECIM) * M * f4, k6_ops),
        "K8": bound(2 * WB_BATCH * f4, NCO_OPS * WB_BATCH),
        "K11": bound(WB_R * 128 * f4, NCO_OPS * WB_R * 64),
        "K10": bound((WB_R + 568) * 128 * f4 + WB_NAUD * 128 * f4,
                     wb_chain + rotate),
        # the live tone, rotated, is one NCO at the offset frequency
        "K12": bound(WB_NAUD * 128 * f4, wb_chain + NCO_OPS * WB_BATCH),
        # the output alone; the NCO and an FFT convolution a sample
        "K9": bound(FIR_R * 128 * f4, (NCO_OPS + FIR_FFT_OPS) * FIR_BATCH),
        # K3's function
        "K3p": bound((n + L) * W * f4 + chain_out, fold + fft + demod + audio),
        # K2 alone at the demod's shape: y and x read, the angle written
        "K2": bound(3 * n * M * f4, ATAN_OPS * n * M),
    }


def graph_ms(fn, reps: int = REPS, inner: int = 10) -> float:
    """Device time of one call without the host's enqueue time: ``inner``
    calls captured once in a CUDA graph, the graph replayed under CUDA
    events (median of ``reps``), divided by ``inner``. Where the host takes
    longer to launch a call than the card to run it (the NCO kernels), an
    event time of back-to-back calls measures the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    return median_ms(g.replay, reps=reps, inner=1) / inner


def alternate(fns: dict, plain_reps: int = REPS) -> dict:
    """The time of each named call, twice: in the reverse of the given
    order, then in it, so each kernel and its plain version alternate.
    Kernels (and compositions of kernels) by graph_ms; the plain versions,
    named '... plain', by median_ms with ``plain_reps`` reps: their torch
    ops run as a caller runs them, host included."""
    names = list(fns)
    out: dict = {}
    for name in names[::-1] + names:
        if name.endswith(" plain"):
            ms = median_ms(fns[name], reps=plain_reps)
        else:
            ms = graph_ms(fns[name])
        out.setdefault(name, []).append(ms)
    return out


def main() -> int:
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.ops import nco as nco_mod
    from newsched_tpu_torch.ops.cuda import (_build, channelizer, fir_source,
                                             fm_chain, mathfns, noise, sources,
                                             wbfm_chain)
    from newsched_tpu_torch.testing import planes_rows

    import torch  # after the port, so a copy without it fails before torch loads

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    # 1. device
    t_start = time.monotonic()
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
    replay_out = phase_replay(rows)
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
    g0 = noise.group_tensor(0, "cuda")  # the sources' counter, on the card
    t = alternate({
        "K3 plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K4 plain": lambda: noise.gaussian_rows_plain(
            g0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
        "K4": lambda: noise.gaussian_rows(
            g0, n_rows=ROWS, width=2 * M, seed=0, device="cuda"),
    })
    k3_t256 = graph_ms(lambda: fm_chain.fm_chain_step_planes(
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
    k5_args = (g0, amp, *st, consts, DECIM, DEMOD_GAIN, ROWS)
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
    # one PyTorch call computing K7's function: the depthwise correlation
    # of every lane with its L taps (cuDNN, FP32: TF32 is off above)
    vT = v.T.contiguous()[None]
    w7 = c2.T.contiguous()[:, None, :]
    lib = {"K7": graph_ms(lambda: torch.nn.functional.conv1d(vT, w7, groups=2 * M))}
    log(f"library call for K7: conv1d(groups={2 * M}) {lib['K7']:.4f} ms [{card}]")

    # 16-20. config #1, the wideband-FM receiver, each path counted
    nco_err = phase_k8_k11(torch, sources)
    k10_err = phase_k10(torch, wbfm_chain)
    k12_err = phase_k12(torch, sources, wbfm_chain)
    wb = phase_wbfm_graphs(torch, sources, wbfm_chain)

    plan, wconsts, _, _ = wb_plan()
    # the stream state as the blocks keep it, on the card: host values would
    # be uploaded by each call, which no CUDA graph capture allows
    ph7 = nco_mod.phase_tensor(7, "cuda")
    dp = nco_mod.phase_tensor(nco_mod.freq_to_dphase(WB_TONE, WB_FS), "cuda")
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    a8 = torch.tensor(0.8, dtype=torch.float32, device="cuda")
    xp = wbfm_chain.fold_planes(fm_signal(WB_BATCH, torch))
    carry = torch.zeros(plan.B8, 128, device="cuda")

    def k11_k10():
        wbfm_chain.wbfm_chain_step(sources.nco_folded(ph7, dp, a8, WB_R, "cuda"),
                                   carry, plan, wconsts)

    t.update(alternate({
        "K8 plain": lambda: sources.nco_planes_plain(ph7, dp, a8, WB_BATCH, "cuda"),
        "K8": lambda: sources.nco_planes(ph7, dp, a8, WB_BATCH, "cuda"),
        "K11 plain": lambda: sources.nco_folded_plain(ph7, dp, a8, WB_R, "cuda"),
        "K11": lambda: sources.nco_folded(ph7, dp, a8, WB_R, "cuda"),
        "K10 plain": lambda: wbfm_chain.wbfm_chain_step_plain(xp, carry, plan,
                                                              wconsts),
        "K10": lambda: wbfm_chain.wbfm_chain_step(xp, carry, plan, wconsts),
        "K12 plain": lambda: wbfm_chain.wbfm_chain_live_step_plain(
            ph7, dp, a8, off, plan, wconsts, WB_R),
        "K11 -> K10": k11_k10,
        "K12": lambda: wbfm_chain.wbfm_chain_live_step(ph7, dp, a8, off, plan,
                                                       wconsts, WB_R),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    for name, what in (("K8", "nco_planes"), ("K11", "nco_folded"),
                       ("K10", "wbfm_chain_step"),
                       ("K12", "wbfm_chain_live_step")):
        log(f"{name} {what}: kernel {t[name]} ms, plain {t[name + ' plain']} ms "
            f"[{card}]")
    log(f"K11 -> K10 (what K12 fuses): {t['K11 -> K10']} ms [{card}]")
    for tile, gs in WB_GEOMS:
        k10_ms = graph_ms(lambda: wbfm_chain.wbfm_chain_step(
            xp, carry, plan, wconsts, tile=tile, seg_group=gs))
        k12_ms = graph_ms(lambda: wbfm_chain.wbfm_chain_live_step(
            ph7, dp, a8, off, plan, wconsts, WB_R, tile=tile, seg_group=gs))
        blocks = (WB_R // tile) * (64 // gs)
        extra = (plan.A + 1) / (tile // (WB_D * WB_RD) * WB_RD)
        smem = wbfm_chain._geometry(plan, WB_R, tile, gs).smem
        log(f"K10/K12 tile {tile} seg_group {gs}: {blocks} blocks, {smem} B "
            f"shared, junction +{100 * extra:.0f}% xlate outputs; K10 "
            f"{k10_ms:.4f} ms, K12 {k12_ms:.4f} ms [{card}]")
    for kind in ("staged", "fused", "folded", "live"):
        wb_step_rate(torch, kind, card)

    # 21-23. config #0, the FIR chain, and K3's pipelined form, each counted
    k9_err = phase_k9(torch, fir_source)
    fir = phase_fir_graphs(torch, sources, fir_source)
    k3p = phase_k3p(torch, fm_chain)

    # 24. times
    _, taps9 = fir_taps(torch)
    dp9 = nco_mod.phase_tensor(nco_mod.freq_to_dphase(FIR_FREQ, FIR_FS), "cuda")
    # the two-call form of K9: K11's tone, then every lane's FIR by one
    # grouped convolution (its look-back is zeros, not the previous
    # segment's samples; cuDNN in FP32, TF32 off above)
    w9 = taps9.flip(0).repeat(128, 1)[:, None, :].contiguous()

    def k11_conv():
        x9 = sources.nco_folded(ph7, dp9, a8, FIR_R, "cuda")
        return torch.nn.functional.conv1d(x9.T[None], w9, groups=128,
                                          padding=FIR_NTAPS - 1)

    # K2 alone (inside K3, K3p, K5, K10, K12) at the demod's shape, beside
    # one PyTorch call computing atan2
    d2 = torch.randn(2, ROWS, M, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    t.update(alternate({
        "K2 plain": lambda: mathfns.atan2_plain(d2[0], d2[1]),
        "K2 library": lambda: torch.atan2(d2[0], d2[1]),
        "K2": lambda: mathfns.atan2(d2[0], d2[1]),
    }))
    log(f"K2 atan2 ({ROWS} x {M}): kernel {t['K2']} ms, plain "
        f"{t['K2 plain']} ms, torch.atan2 {t['K2 library']} ms [{card}]")
    t.update(alternate({
        "K9 plain": lambda: fir_source.fir_tone_step_plain(
            ph7, dp9, a8, off, taps9, 1, FIR_R),
        "K11 -> conv1d": k11_conv,
        "K9": lambda: fir_source.fir_tone_step(ph7, dp9, a8, off, taps9, 1,
                                               FIR_R),
        "K3p plain": lambda: fm_chain.fm_chain_step_planes_plain(
            vb, *st, consts, DECIM, DEMOD_GAIN),
        "K3p": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN, pipelined=True),
        "K3 beside K3p": lambda: fm_chain.fm_chain_step_planes(
            vb, *st, consts, DECIM, DEMOD_GAIN),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    lib["K2"] = ms["K2 library"]
    log(f"K9 fir_tone_step ({FIR_R} x 128 rows, {FIR_NTAPS} taps): kernel "
        f"{t['K9']} ms, plain {t['K9 plain']} ms; K11 -> conv1d(groups=128) "
        f"{t['K11 -> conv1d']} ms [{card}]")
    log(f"K3p fm_chain_step_planes(pipelined=True) ({ROWS} x {2 * M} rows): "
        f"kernel {t['K3p']} ms, K3 {t['K3 beside K3p']} ms, plain "
        f"{t['K3p plain']} ms [{card}]")
    for tile, gs in K9_GEOMS:
        k9_ms = graph_ms(lambda: k9_at(fir_source, tile, gs)(
            ph7, dp9, a8, off, taps9, 1, FIR_R))
        g = fir_source._geometry(FIR_R, 1, FIR_NTAPS, tile, gs)
        log(f"K9 tile {tile} seg_group {gs}: {(FIR_R // tile) * (64 // gs)} "
            f"blocks of {-(-tile // g.CU)} chunk(s), {g.smem} B shared; "
            f"{k9_ms:.4f} ms [{card}]")
    def first_rows(tile):  # rows K3 folds and transforms for a tile
        return -(-(tile + A) // 32) * 32

    log(f"K3 junction: {first_rows(128)} rows folded and transformed for a "
        f"tile of 128 (+{100 * (first_rows(128) - 128) / 128:.0f}%)")
    for tile in (128, 64):
        smem = fm_chain._pipe_smem(tile, A, L, 2 * M)
        default = fm_chain._pipe_tiles_per_block(
            ROWS // tile, smem,
            torch.cuda.get_device_properties(0).multi_processor_count)
        for G in sorted({default, *K3P_GS}):
            k3p_ms = graph_ms(lambda: fm_chain._pipe(
                vb, *st, consts, DECIM, DEMOD_GAIN, tile, G))
            rows_done = first_rows(tile) + (G - 1) * tile
            mark = " (default)" if G == default else ""
            log(f"K3p tile {tile}, {G} tiles a block{mark}: "
                f"{-(-(ROWS // tile) // G)} blocks, {smem} B shared, junction "
                f"+{100 * (rows_done - G * tile) / (G * tile):.0f}% rows; "
                f"{k3p_ms:.4f} ms [{card}]")
    for kind in ("staged", "live"):
        fir_step_rate(torch, kind, card)

    # 25-28. sharding: K6, then the sharded graphs against the unsharded
    from newsched_tpu_torch.parallel import make_mesh

    k6_err = phase_k6(torch, fm_chain, noise)
    k6_launches = phase_sharded_live(fm_chain, fused_out)
    k3_warm_launches, k3_warm_err = phase_sharded_fused(torch, fm_chain, rows,
                                                        replay_out)
    sharded, shard_err = phase_sharded_receivers(torch, sources, wbfm_chain,
                                                 fir_source, wb, fir)
    k3_err = max(k3_err, k3_warm_err)
    k10_err = max(k10_err, shard_err["K10"])
    k12_err = max(k12_err, shard_err["K12"])
    k9_err = max(k9_err, shard_err["K9"])

    # 29. times
    b6 = noise.group_tensor(3 * K6_ROWS // 64, "cuda")  # shard 3's base
    t.update(alternate({
        "K6 plain": lambda: fm_chain.fm_chain_gen_warm_step_plain(
            b6, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, K6_WARM),
        "K5 beside K6": lambda: fm_chain.fm_chain_gen_step(*k5_args),
        "K6 at 32768": lambda: fm_chain.fm_chain_gen_warm_step(
            b6, amp, consts, DECIM, DEMOD_GAIN, ROWS, warm=K6_WARM),
        "K6": lambda: fm_chain.fm_chain_gen_warm_step(
            b6, amp, consts, DECIM, DEMOD_GAIN, K6_ROWS, warm=K6_WARM),
    }, PLAIN_REPS))
    ms = {k: min(v_) for k, v_ in t.items()}
    log(f"K6 fm_chain_gen_warm_step: {K6_ROWS} rows {t['K6']} ms, {ROWS} rows "
        f"{t['K6 at 32768']} ms; K5 at {ROWS} rows {t['K5 beside K6']} ms; "
        f"plain ({K6_ROWS} rows) {t['K6 plain']} ms [{card}]")
    # one sharded step is profiled: each is its shards' kernels in a row
    for n in MESHES:
        step_rate(torch, "live", f"live, {n} shards", card, mesh=make_mesh(n),
                  profile=n == MESHES[0])
        step_rate(torch, general.vector_source(rows, repeat=True),
                  f"replay, {n} shards", card, mesh=make_mesh(n), profile=False)
    # 30-33. graph mode against the loop, parameter changes, the on-card
    # counters, the probes against their plain versions
    graph_launches = phase_graph_mode(rows, wb, fir)
    phase_params()
    phase_counters(torch, fm_chain, noise)
    probe_err = phase_probes(torch, fm_chain)

    # 34. times: graph mode, the chunk, the bench's timer, the probes
    phase_graph_times(torch, rows, card)
    pt = phase_probe_times(torch, card)
    ms.update(pt["t"])
    lib["window_copy"] = pt["t"]["window_copy library"]
    lib["planes_unpack"] = pt["t"]["planes_unpack library"]
    ms["ablate plain"] = ms["K3 plain"]
    log(f"script time before the bounds: {time.monotonic() - t_start:.1f} s")

    bounds = kernel_bounds()
    # the probes: each input read once, each output written once
    bounds["window_copy"] = bound(pt["x_bytes"] + pt["n_tiles"] * 8 * 128 * 4, 0)
    bounds["planes_unpack"] = bound(2 * pt["stream_bytes"], 0)
    bounds["ablate"] = bounds["K3"]  # its "full" instance is K3
    for name, (b_ms, by) in bounds.items():
        log(f"bound {name}: {b_ms:.4f} ms ({by}); kernel {ms[name]:.4f} ms, "
            f"roofline share {100 * b_ms / ms[name]:.1f}% [{card}]")
    log(f"graph-mode launches on the main paths of phase 30: {graph_launches}")

    def entry(name, kid, src, replaces, launches, err):
        if not replaces.startswith("bench/"):
            replaces = f"newsched_tpu/ops/pallas/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"newsched_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": launches, "max_abs_err": err,
                "ms": ms[kid], "plain_ms": ms[kid + " plain"],
                "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
                "library_ms": lib.get(kid)}

    wl = wb["launches"]
    print(json.dumps({"kernels": [
        entry("fm_chain_step_planes", "K3", "fm_chain.cu", "fm_chain.py:421",
              launches["fm_chain"] + k3_warm_launches, k3_err),
        entry("gaussian_rows", "K4", "noise.cu", "noise.py:176",
              launches["noise"], k4_err),
        entry("arm_fold_dft", "K1", "channelizer.cu", "channelizer.py:209",
              staged["arm_fold_dft"], fold_err["arm_fold_dft"]),
        entry("arm_fold", "K7", "channelizer.cu", "channelizer.py:95",
              dec_launches, fold_err["arm_fold"]),
        entry("fm_chain_gen_step", "K5", "fm_chain.cu", "fm_chain.py:591",
              live_launches, k5_err),
        entry("nco_planes", "K8", "sources.cu", "sources.py:44",
              wl["staged"]["K8"] + wl["fused"]["K8"]
              + fir["launches"]["staged"]["K8"] + sharded["K8"], nco_err["K8"]),
        entry("nco_folded", "K11", "sources.cu", "sources.py:91",
              wl["folded"]["K11"], nco_err["K11"]),
        entry("wbfm_chain_step", "K10", "wbfm_chain.cu", "wbfm_chain.py:364",
              wl["fused"]["K10"] + wl["folded"]["K10"] + sharded["K10"],
              k10_err),
        entry("wbfm_chain_live_step", "K12", "wbfm_chain.cu",
              "wbfm_chain.py:452", wl["live"]["K12"] + sharded["K12"], k12_err),
        entry("fir_tone_step", "K9", "fir_source.cu", "fir_source.py:89",
              fir["launches"]["live"]["K9"] + sharded["K9"], k9_err),
        entry("fm_chain_step_planes[pipelined]", "K3p", "fm_chain.cu",
              "fm_chain.py:315", k3p["launches"], k3p["err"]),
        entry("fm_chain_gen_warm_step", "K6", "fm_chain.cu", "fm_chain.py:724",
              k6_launches, k6_err),
        entry("window_copy", "window_copy", "probes.cu", "bench/exp_dma.py:93",
              pt["launches"]["window_copy"], probe_err["window_copy"]),
        entry("planes_unpack", "planes_unpack", "probes.cu",
              "bench/exp_prep.py:119", pt["launches"]["planes_unpack"],
              probe_err["planes_unpack"]),
        entry("fm_chain_step_planes[ablate]", "ablate", "fm_chain.cu",
              "bench/exp_ablate.py:128", pt["launches"]["ablate"],
              probe_err["ablate"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
