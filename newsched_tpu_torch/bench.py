"""The port's benchmark: the flowgraphs of the three model configurations,
timed in the runner's graph mode on one GPU (reference: the root
``bench.py``, which times the JAX package's compiled step as a ``lax.scan``
of K steps, the program of its runner's scan mode).

    python3 -m newsched_tpu_torch.bench                  # on the card
    python3 -m newsched_tpu_torch.bench --device cpu     # a small CPU run

Prints ONE JSON line last, with the reference's keys: ``metric``,
``value`` (the fused 64-channel FM channelizer flowgraph over a replayed
batch), ``unit``, ``vs_baseline``, and ``live_value``,
``wbfm_{staged,fused,live}_value``, ``fir_{staged,live}_value``, and
``fft_filter_value`` (config #3, the reference's ``bench/bm_micro.py``
``bm_fft_filter``), in Msamples/s of input on one GPU. Each value stands behind its SNR gate
against a float64 golden; a path whose gate fails is left out, as in the
reference. The lines before give each path's step in microseconds, the
dispatch overhead and the card's name and power limit; a ``device`` key in
the last line names where it ran (a CPU run's numbers are the CPU's).

How it times (the reference's ``_timed_two_point``): a run of k steps
starts from the initial state, as the reference's ``run_k`` does. The
graph's chunk of ``runner.GRAPH_CHUNK`` steps is captured once as a CUDA
graph; a run resets the stream state on the card by ``copy_`` from a
snapshot and replays the chunk k // C times (the remainder stepped
directly), exactly what ``Runner._run_graph`` does, and returns each
step's checksum. T(k) is its time by CUDA events, ended by
``torch.cuda.synchronize``, the best of ``n_best``; the step is
(T(K2) - T(K1)) / (K2 - K1), with the fixed cost of a run (the dispatch)
taken out, and reported separately.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from newsched_tpu_torch import models
from newsched_tpu_torch.blocks import analog, filter as filt, general
from newsched_tpu_torch.ops import firdes, nco
from newsched_tpu_torch.ops.cuda import fm_chain, noise
from newsched_tpu_torch.runtime import runner as rt
from newsched_tpu_torch.runtime.runner import Runner
from newsched_tpu_torch.testing import (fir_golden, fxpt_tone, planes_rows,
                                        rows_reference, snr_db, wbfm_golden)

NCHANS = 64
TAPS_PER_ARM = 16
AUDIO_DECIM = 8
AUDIO_NTAPS = 65
DEMOD_GAIN = 0.5
K1, K2 = 100, 400      # the reference's two points
BATCH = 1 << 21        # the reference's batch (wideband samples)
# --device cpu: a small batch for the tests, the receiver's smallest over
# its 568-row junction
CPU_BATCH = 40960
GATE_DB = 60.0         # bench.py:585 (flowgraph), :432 (wbfm), :508 (fir)
# The reference's pinned single-core CPU rate of the chain (bench.py
# PINNED_CPU_SPS, numpy/scipy on its build machine): the vs_baseline
# denominator, kept so the ratio means what the reference's means; this
# script's own CPU remeasure is a log line only.
PINNED_CPU_SPS = 9.53e6
WB_FS, WB_FC, WB_D, WB_RD, WB_DEV = 1e6, 200e3, 4, 5, 75e3
WB_TONE = 231_250.0    # 31.25 kHz into the 100 kHz channel: nonzero audio
FIR_FS, FIR_FREQ, FIR_NTAPS = 1e6, 123_456.0, 128
FFT_NTAPS, FFT_AMP = 1024, 0.5   # config #3 (bench/bm_micro.py bm_fft_filter)
FFT_GATE_DB = 85.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def design():
    taps = firdes.prototype_channelizer_taps(NCHANS, TAPS_PER_ARM)
    audio_taps = firdes.low_pass(1.0, 1.0, 0.4 / AUDIO_DECIM,
                                 0.1 / AUDIO_DECIM, ntaps=AUDIO_NTAPS)
    return taps, audio_taps


def _golden(rows, taps, audio_taps):
    return rows_reference(rows, taps, audio_taps, nchans=NCHANS,
                          audio_decim=AUDIO_DECIM, demod_gain=DEMOD_GAIN,
                          return_risk=True)


def live_golden_rows(B: int) -> np.ndarray:
    """The live source's stream (seed 0, amplitude 0.5, three draws: the
    models' source="live" defaults), regenerated by the plain generator
    for the float64 golden."""
    return 0.5 * noise.gaussian_rows_plain(
        0, n_rows=B // NCHANS, width=2 * NCHANS, seed=0, device="cpu").numpy()


def cpu_fast_chain(x: np.ndarray, taps, audio_taps) -> np.ndarray:
    """The reference's single-core CPU chain (bench.py cpu_fast_chain):
    float32, vectorised numpy/scipy, the same polyphase algorithm."""
    import scipy.fft
    import scipy.signal as sig

    from newsched_tpu_torch.ops.pfb import pfb_arm_taps

    M = NCHANS
    arm = pfb_arm_taps(taps.astype(np.float32), M)
    L = arm.shape[1]
    n_out = len(x) // M
    need = L - 1 + n_out
    xfull = np.concatenate([np.zeros(M * L - 1, np.complex64), x])
    U = np.ascontiguousarray(xfull[:need * M].reshape(need, M)[:, ::-1].T)
    arm_rev = arm[:, ::-1]
    filt = np.zeros((M, n_out), np.complex64)
    for l in range(L):
        filt += arm_rev[:, l:l + 1] * U[:, l:l + n_out]
    Y = (M * scipy.fft.ifft(filt, axis=0, workers=1)).astype(np.complex64).T
    prev = np.vstack([np.zeros((1, M), np.complex64), Y[:-1]])
    aud = (np.angle(np.conj(prev) * Y) * np.float32(DEMOD_GAIN)).astype(
        np.float32)
    return sig.lfilter(audio_taps.astype(np.float32), [1.0], aud,
                       axis=0)[::AUDIO_DECIM]


def cpu_reference_throughput(taps, audio_taps, n: int = 1 << 20) -> float:
    rng = np.random.default_rng(0)
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.5
         ).astype(np.complex64)
    cpu_fast_chain(x[:n // 4], taps, audio_taps)
    t0 = time.perf_counter()
    cpu_fast_chain(x, taps, audio_taps)
    sps = n / (time.perf_counter() - t0)
    log(f"cpu: {n} samples -> {sps / 1e6:.2f} Msamples/s on one host core "
        f"(a log line; vs_baseline divides by the reference's pinned "
        f"{PINNED_CPU_SPS / 1e6:.2f})")
    return sps


# -- the timer --------------------------------------------------------------

class StreamRun:
    """k steps of a compiled step from the initial state, through a
    captured chunk (``runner._Chunk``): ``step(states, params) -> (states,
    {name: per-step checksum})``. The chunk is captured at the first run;
    each run resets the stream state by ``copy_`` from its snapshot."""

    def __init__(self, step, states: dict, params: dict, device,
                 chunk: int = rt.GRAPH_CHUNK):
        self.snapshot = rt._clone(states)
        self.chunk = rt._Chunk(step, states, params, chunk, device)

    def __call__(self, k: int) -> torch.Tensor:
        c = self.chunk
        rt._copy_into(c.states, self.snapshot)
        outs = [c.run() for _ in range(k // c.C)]
        if k % c.C:
            outs.append(c.steps(k % c.C))
        return torch.cat([v for o in outs for v in o.values()])


def graph_run(fg, device, chunk: int = rt.GRAPH_CHUNK, mesh=None) -> StreamRun:
    """A flowgraph with one null sink, compiled by the runner, as a
    StreamRun of its step."""
    fg.validate()
    r = Runner(fg, device=device, batch_size=fg.batch_size, mesh=mesh)
    return StreamRun(r.cfg.step, r.init_states(), r.init_params(), device,
                     chunk)


def timed_two_point(run_k, label: str, B: int, n_best: int = 3,
                    k1: int = K1, k2: int = K2) -> float:
    """The reference's two-point fit: T(k) the best of ``n_best`` runs of k
    steps (CUDA events around the run, ended by a synchronize; the host
    clock on the CPU), step = (T(k2) - T(k1)) / (k2 - k1), the fixed cost
    T(k1) - k1 * step. Every run's checksums must be finite. Returns input
    samples per second."""
    cuda = torch.cuda.is_available() and isinstance(run_k, StreamRun) \
        and run_k.chunk.cuda
    t0 = time.perf_counter()
    sums = run_k(k1)
    first = float(sums[0])
    log(f"{label}: capture + first {k1} steps {time.perf_counter() - t0:.2f} s; "
        f"checksum[0]={first:.1f}")
    totals = {}
    for k in (k1, k2):
        best = np.inf
        for _ in range(n_best):
            if cuda:
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s.record()
                sums = run_k(k)
                e.record()
                torch.cuda.synchronize()
                dt = s.elapsed_time(e) * 1e-3
            else:
                t = time.perf_counter()
                sums = run_k(k)
                dt = time.perf_counter() - t
            best = min(best, dt)
            assert bool(torch.isfinite(sums).all()), f"{label}: non-finite"
        totals[k] = best
    step_s = (totals[k2] - totals[k1]) / (k2 - k1)
    if step_s <= 0:  # the host clock of a loaded CPU: no fit, the mean
        step_s = totals[k2] / k2
    dispatch_s = totals[k1] - k1 * step_s
    sps = B / step_s
    log(f"{label}: T({k1})={totals[k1] * 1e3:.3f} ms T({k2})="
        f"{totals[k2] * 1e3:.3f} ms -> {step_s * 1e6:.2f} us/step "
        f"({sps / 1e6:.1f} Msamples/s); dispatch overhead "
        f"{dispatch_s * 1e3:.3f} ms/run (naive with it: "
        f"{B * k1 / totals[k1] / 1e6:.1f} Msamples/s)")
    return sps


# -- the paths ----------------------------------------------------------------

def _fm_graph(source, B, sink, taps, audio_taps, n_samples=None):
    return models.fm_channelizer(
        nchans=NCHANS, taps_per_arm=TAPS_PER_ARM, audio_decim=AUDIO_DECIM,
        source=source, batch_size=B, sink=sink, fused=True,
        n_samples=n_samples, deviation_frac=1.0 / (2 * np.pi * DEMOD_GAIN),
        audio_taps=audio_taps)


def graph_paths(taps, audio_taps, batch: int, device):
    """The headline: the fused flowgraph (planes-rows replay source ->
    fused chain block -> null_sink), compiled by the runner and run in its
    graph mode. Returns (run_k, gate_audio, rows, B)."""
    M = NCHANS
    B = max(batch // (M * AUDIO_DECIM), 1) * M * AUDIO_DECIM
    rng = np.random.default_rng(0)
    xc = ((rng.standard_normal(B) + 1j * rng.standard_normal(B)) * 0.5
          ).astype(np.complex64)
    rows = planes_rows(xc, M)
    fg, _ = _fm_graph(general.vector_source(rows, repeat=True), B, "null",
                      taps, audio_taps)
    run_k = graph_run(fg, device)

    def gate_audio():
        fg2, blks = _fm_graph(general.vector_source(rows, repeat=True), B,
                              "vector", taps, audio_taps,
                              n_samples=B // M // AUDIO_DECIM)
        fg2.run(device=device)
        return blks["sink"].data()

    return run_k, gate_audio, rows, B


def live_paths(taps, audio_taps, batch: int, device):
    """The live flagship: fm_noise_channelizer_source (K5) -> null_sink.
    Returns (run_k, gate_audio, B)."""
    M = NCHANS
    B = max(batch // (M * AUDIO_DECIM), 1) * M * AUDIO_DECIM
    fg, _ = _fm_graph("live", B, "null", taps, audio_taps)

    def gate_audio():
        fg2, blks = _fm_graph("live", B, "vector", taps, audio_taps,
                              n_samples=B // M // AUDIO_DECIM)
        fg2.run(device=device)
        return blks["sink"].data()

    return graph_run(fg, device), gate_audio, B


def gated(label: str, ref, got, gate_db: float = GATE_DB) -> bool:
    snr = snr_db(ref, got)
    log(f"{label}: SNR vs float64 golden = {snr:.2f} dB (gate >= {gate_db})")
    if not (np.isfinite(snr) and snr >= gate_db):
        log(f"{label}: gate FAILED - value withheld")
        return False
    return True


def wbfm_graph(kind: str, B: int, sink: str, n_samples=None):
    """Config #1 at the reference's bench settings: staged, fused (a cf32
    sig_source) or live, on the fixed-point tone at WB_TONE."""
    src = ("live" if kind == "live"
           else analog.sig_source(WB_FS, "complex", frequency=WB_TONE))
    fg, blks = models.wbfm_receiver(
        fs=WB_FS, center_freq=WB_FC, quad_rate_decim=WB_D,
        audio_decim=(1, WB_RD), deviation=WB_DEV, source=src, batch_size=B,
        sink=sink, fused=kind != "staged", n_samples=n_samples)
    if kind == "live":
        blks["source"].set_frequency(WB_TONE)
    return fg, blks


def wbfm_paths(batch: int, device, k1=K1, k2=K2) -> dict:
    """Config #1's staged, fused and live receivers, each gated >= 60 dB
    against the float64 staged-semantics golden, then timed. Returns
    {kind: samples/s}."""
    unit = 64 * 8 * WB_D * WB_RD
    B = max(batch // unit, 1) * unit
    chan = firdes.low_pass(1.0, WB_FS, 100e3, 30e3)
    rtaps = firdes.low_pass(1.0, 1.0, 0.45 / WB_RD, 0.1 / WB_RD)
    ref = wbfm_golden(fxpt_tone(B, nco.freq_to_dphase(WB_TONE, WB_FS)), chan,
                      nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rtaps, WB_RD,
                      (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    out = {}
    for kind in ("staged", "fused", "live"):
        fg, blks = wbfm_graph(kind, B, "vector", B // (WB_D * WB_RD))
        fg.run(device=device)
        got = blks["sink"].data()
        if not gated(f"wbfm[{kind}]", ref[:len(got)], got):
            continue
        fg, _ = wbfm_graph(kind, B, "null")
        out[kind] = timed_two_point(graph_run(fg, device),
                                    f"wbfm {kind} flowgraph", B, n_best=5,
                                    k1=k1, k2=k2)
    return out


def fir_paths(batch: int, device, k1=K1, k2=K2) -> dict:
    """Config #0's staged and live FIR chains, each gated >= 60 dB against
    the float64 fixed-point-tone golden, then timed."""
    B = max(batch // 1024, 1) * 1024
    taps = firdes.low_pass(1.0, FIR_FS, 0.2 * FIR_FS, 0.05 * FIR_FS,
                           ntaps=FIR_NTAPS)
    ref = fir_golden(B, taps, FIR_FREQ, FIR_FS)
    out = {}
    for kind in ("staged", "live"):
        src = "live" if kind == "live" else None

        def graph(n, sink, src=src):
            return models.fir_chain(n_samples=n, fs=FIR_FS, ntaps=FIR_NTAPS,
                                    frequency=FIR_FREQ, batch_size=B,
                                    sink=sink, source=src)

        fg, b = graph(B, "vector")
        fg.run(device=device)
        if not gated(f"fir_chain[{kind}]", ref, b["sink"].data()):
            continue
        fg, _ = graph(B * 1000, "null")
        out[kind] = timed_two_point(graph_run(fg, device),
                                    f"fir_chain {kind} flowgraph", B,
                                    n_best=5, k1=k1, k2=k2)
    return out


def fft_filter_taps(ntaps: int = FFT_NTAPS) -> np.ndarray:
    """Config #3's low-pass: firdes.low_pass(1.0, 1.0, 0.1, 0.02)."""
    return firdes.low_pass(1.0, 1.0, 0.1, 0.02, ntaps=ntaps)


def fft_filter_graph(n_samples: int, batch: int, sink: str = "null",
                     fft_method: str = "auto", fft_size=None,
                     ntaps: int = FFT_NTAPS):
    """Config #3, the reference's ``bench/bm_micro.py`` ``bm_fft_filter``:
    noise_source("gaussian", 0.5) (K4) -> fft_filter (the 1024-tap
    ``fft_filter_taps``) -> head(n_samples) -> sink, in batches of
    ``batch`` samples. Returns (Flowgraph, dict of its blocks and taps)."""
    from newsched_tpu_torch.runtime.graph import Flowgraph

    taps = fft_filter_taps(ntaps)
    fg = Flowgraph("fft_filter", batch_size=batch)
    src = analog.noise_source("gaussian", FFT_AMP)
    f = filt.fft_filter(taps, fft_size=fft_size, fft_method=fft_method)
    hd = general.head(n_samples)
    snk = general.null_sink() if sink == "null" else general.vector_sink()
    fg.connect(src, 0, f, 0)
    fg.connect(f, 0, hd, 0)
    fg.connect(hd, 0, snk, 0)
    return fg, {"source": src, "filter": f, "head": hd, "sink": snk,
                "taps": taps}


def fft_filter_golden(n: int, taps, device="cpu") -> np.ndarray:
    """Float64 golden of config #3 from stream start: the first n samples
    of noise_source's stream (seed 0, amplitude 0.5), regenerated by K4's
    plain version on ``device``, through the taps: the zero-state
    convolution (scipy.signal.lfilter's), as scipy's float64 FFT
    convolution."""
    import scipy.signal as sig

    x = noise.gaussian_rows_plain(0, n_rows=-(-2 * n // 128), width=128,
                                  seed=0, device=device, amp=FFT_AMP,
                                  layout="cf32")[:n].cpu().numpy()
    return sig.fftconvolve(x.astype(np.complex128),
                           np.asarray(taps, np.float64))[:n]


def fft_filter_paths(batch: int, device, k1=K1, k2=K2) -> dict:
    """Config #3's graph, gated >= 85 dB against its float64 golden over
    two batches, then timed."""
    B = max(batch // 4096, 1) * 4096  # whole noise groups of cf32 samples
    fg, b = fft_filter_graph(2 * B, B, "vector")
    fg.run(device=device)
    if not gated("fft_filter", fft_filter_golden(2 * B, b["taps"], device),
                 b["sink"].data(), FFT_GATE_DB):
        return {}
    fg, _ = fft_filter_graph(B * 1000, B, "null")
    return {"fft_filter": timed_two_point(graph_run(fg, device),
                                          "fft_filter flowgraph", B,
                                          n_best=5, k1=k1, k2=k2)}


def bespoke_path(taps, audio_taps, rows: np.ndarray, device) -> StreamRun:
    """The framework-bypass number: K3 called directly on the same batch
    with its carried state, no compiler and no runner, captured the same
    way (reference: bench.py bespoke_path, the shard_map pipeline)."""
    from newsched_tpu_torch.blocks import vector_dsp

    blk = vector_dsp.fm_channelizer_fused_planes(
        NCHANS, taps, audio_taps, audio_decim=AUDIO_DECIM, gain=DEMOD_GAIN)
    consts = blk.consts(device)
    vb = torch.from_numpy(rows).to(device)
    H8 = blk.h8

    def step(st, _params):
        aud, prev, tail = fm_chain.fm_chain_step_planes(
            vb, st["carry"], st["prev"], st["atail"], consts, AUDIO_DECIM,
            DEMOD_GAIN)
        return ({"carry": vb[-H8:], "prev": prev, "atail": tail},
                {"sum": aud.abs().sum()})

    return StreamRun(step, blk.chain_state(device), {}, device)


# -- main ---------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def run(device: str = "cuda", k1: int = K1, k2: int = K2) -> dict:
    """Every path, gated and timed, at the reference's batch on the card
    (CPU_BATCH on the CPU); returns the last line's object."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card "
                           "(pass --device cpu for a small CPU run)")
    batch = BATCH if cuda else CPU_BATCH
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        where = torch.cuda.get_device_name(0)
        log(f"card: {card_line()} (x {torch.cuda.device_count()}); torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
    else:
        where = "cpu"
        log("device: cpu (a CPU run: every number below is the host's)")
    taps, audio_taps = design()
    cpu_reference_throughput(taps, audio_taps, n=min(1 << 20, 8 * batch))
    run_graph, gate_audio, rows, B = graph_paths(taps, audio_taps, batch,
                                                 device)
    log(f"batch {B} samples, graph chunk {rt.GRAPH_CHUNK} steps, K {k1}/{k2}")
    out = {"metric": "fm_channelizer_64ch_flowgraph_throughput",
           "value": 0.0, "unit": "Msamples/s/gpu", "vs_baseline": 0.0,
           "device": where}
    ref, bad = _golden(rows, taps, audio_taps)
    audio = gate_audio()
    log(f"correctness: {int(bad.sum())} of {bad.size} audio samples masked "
        f"as atan2-branch-cut-ambiguous")
    if not gated("flowgraph", ref[~bad], audio[~bad]):
        out["error"] = "SNR gate failed"
        return out
    sps = timed_two_point(run_graph, "flowgraph (graph mode)", B, k1=k1,
                          k2=k2)
    out["value"] = round(sps / 1e6, 2)
    out["vs_baseline"] = round(sps / PINNED_CPU_SPS, 2)
    bespoke = timed_two_point(bespoke_path(taps, audio_taps, rows, device),
                              "bespoke K3 loop", B, k1=k1, k2=k2)
    log(f"framework overhead: the flowgraph at {100 * sps / bespoke:.1f}% of "
        f"the bespoke K3 loop")
    run_live, gate_live, Bl = live_paths(taps, audio_taps, batch, device)
    ref_l, bad_l = _golden(live_golden_rows(Bl), taps, audio_taps)
    a_live = gate_live()
    if gated("live flowgraph", ref_l[~bad_l], a_live[~bad_l]):
        out["live_value"] = round(timed_two_point(
            run_live, "live flowgraph", Bl, n_best=5, k1=k1, k2=k2) / 1e6, 2)
    for kind, v in wbfm_paths(batch, device, k1, k2).items():
        out[f"wbfm_{kind}_value"] = round(v / 1e6, 2)
    for kind, v in fir_paths(batch, device, k1, k2).items():
        out[f"fir_{kind}_value"] = round(v / 1e6, 2)
    for kind, v in fft_filter_paths(batch, device, k1, k2).items():
        out[f"{kind}_value"] = round(v / 1e6, 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k1", type=int, default=None)
    ap.add_argument("--k2", type=int, default=None)
    a = ap.parse_args(argv)
    cuda = torch.device(a.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        log("newsched_tpu_torch.bench: no CUDA device (--device cpu for a "
            "small CPU run)")
        return 2
    k1 = a.k1 or (K1 if cuda else 2)
    k2 = a.k2 or (K2 if cuda else 6)
    print(json.dumps(run(a.device, k1=k1, k2=k2)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
