"""Stage times of the live FIR kernel K9 and the wideband-FM tile routine
(K10, K12), and their outputs and the fused channelizer chains' (K3, K3
with warm > 0, K3p, K3ag, K5, K6 at M = 64) for comparison across trees;
the noise kernel K4's and the noise blocks' outputs and times, and K9's
past the FFT's 513 taps, for the same comparison.

    PYTHONPATH=<tree> python3 <this file> stages
    PYTHONPATH=<tree> python3 <this file> outputs --save FILE
    PYTHONPATH=<tree> python3 <this file> outputs --compare FILE
    PYTHONPATH=<tree> python3 <this file> times
    PYTHONPATH=<tree> python3 <this file> sharded

``stages`` copies ``csrc/fir_source.cu``, ``csrc/fir_part.cu`` and
``csrc/wbfm_chain.cu`` of the package on the path (this tree, or one
unpacked with ``git archive`` of an earlier commit: the cuts know the
direct-form K9 and its FFT form) into
``build/stages/``, inserts cuts there behind a ``STAGE`` macro, builds one
library a stage with ``-DSTAGE=n`` and times each beside the untouched
kernels, on one input and over 4 rotating outputs (and inputs, for K10).
The cuts are cumulative, each stage keeps its shared-memory results alive
and skips what follows:
  K9 direct form: 1 the samples generated; 2 + the FIR and the writes;
  K9 FFT form: 1 the samples generated; 2 + the transforms; 3 + the writes;
  K9 partitioned (``csrc/fir_part.cu``, at 1024 taps): 1 the samples
       generated; 2 + the forward transforms and the spectra's sum; 3 + the
       inverse transform; 4 + the writes;
  K10, K12: 1 the samples staged (read, or generated); 2 + the xlate FIR;
       3 + the demod and atan2; 4 + the resampler and the writes.

``outputs`` runs K9, K10 and K12 at the main paths' shapes on fixed inputs
(K10 and K12 at several block geometries; K9 also at 1024 taps, past the
FFT instance), the chain kernels at the flagship's shape on seeded rows
(K3's ablation variants too; and K3, K3ag, K5, K6 at M = 128 .. 448,
512 and 1024, a width the tree refuses skipped; K1 at M = 64 .. 448; S3
at K = 3, 7, 11, 12, 15),
K4 at the flagship's 32768 x 128 (with and without an amplitude, as rows
and as the cf32 stream, at group 2^32 - 2 and at a negative group with
mask_pre), two batches of each noise block (``noise_planes_source``,
``noise_source`` cf32 and rf32) and the audio of the config #2 fused-noise
and staged graphs (two batches, graph mode), and saves them, or compares
them with a saved run: each record says whether the two are bit-equal and
their largest difference. A tree whose noise kernel takes no amplitude
gets its blocks' own ``r * amp`` and torch.complex build.

``times`` times, alternating, by CUDA-graph replay: K4 at 32768 x 128
alone, with the amplitude and as the cf32 stream (in a tree without them,
the kernel and the blocks' torch ops after it); K9 at 128, 1024 and 6001
taps; K1 at M = 320 on 16384 rows (whichever instance the tree routes
that width to), S3 at 1024 frames of 512 bits, K = 7 (the tree's
default instance), K3 and K5 at M = 128, 256, 320, 448, 512 and 1024
on 16384 rows and K6 on 4096 (a width the tree refuses left out); and
the graph-mode steps of the config #2 fused-noise, staged and
live graphs, the live graph on 4 and 8 shards, the staged graph at M =
320, 512 and 1024 (16384 rows a batch; a width the tree refuses is
recorded as its error) and the live fir_chain at 1024 taps (the bench's
two-point fit).

``sharded`` times the graph-mode steps of the sharded graphs (#2 fused
replay, #1 fused, #1 live, #0 live) unsharded and on 4 and 8 logical
shards, each sharded graph in its one launch a batch and in the
per-shard loop it ran before (``shard_loops``, a cut copy of the four
hooks), in turns.

Prints one JSON line a record, the card's name and power limit first.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from newsched_tpu_torch.ops import fec, firdes, nco, pfb
from newsched_tpu_torch.ops.cuda import (_build, channelizer, fec as kfec,
                                         fir_source, fm_chain, sources,
                                         wbfm_chain)
from newsched_tpu_torch.probes import ablate
from newsched_tpu_torch.probes._timing import graph_ms
from newsched_tpu_torch.probes.run import rotating

FIR_R, FIR_NTAPS, FIR_FS, FIR_FREQ = 32768, 128, 1e6, 123_456.0
WB_R, WB_FS, WB_FC, WB_D, WB_RD, WB_DEV = 32640, 1e6, 200e3, 4, 5, 75e3
WB_TONE = 231_250.0
WB_OUT_GEOMS = ((None, 4), (1020, 4), (2040, 8), (4080, 16), (None, 8))

_KEEP = "if ({a}[tid] == 1234.5f) {out}[tid] = {b}[tid];"
_KEEP2 = "if ({a}[tid].x == 1234.5f) {out}[tid] = {a}[tid].y;"
# for each file, each form of its kernels: (anchor, text inserted before
# it) a cut, and the names of the stages the cuts leave (the last: none)
_FORMS = {
    "fir_source.cu": {
        "direct": ([
            ("    if (mm0 < cu) {\n      float ar[kJ], ai[kJ];\n      fir_outputs(",
             "#if STAGE < 2\n    " + _KEEP.format(a="xre", b="xim", out="p.out")
             + "\n    continue;\n#endif\n"),
        ], ("gen", "full")),
        "fft": ([
            ("  const int g = tid / Q, t = tid % Q;",
             "#if STAGE < 2\n  " + _KEEP2.format(a="win", out="p.out")
             + "\n  return;\n#endif\n"),
            ("    // (3) this round's outputs to their rows",
             "#if STAGE < 3\n    " + _KEEP2.format(a="xbuf", out="p.out")
             + "\n    continue;\n#endif\n"),
        ], ("gen", "fft", "full")),
    },
    "wbfm_chain.cu": {
        "direct": ([
            ("    if (mm0 < cu) {\n      float ar[kJ], ai[kJ];\n      xlate_outputs(",
             "#if STAGE < 2\n    " + _KEEP.format(a="xre", b="xim", out="p.aud")
             + "\n    continue;\n#endif\n"),
            ("  // 2. d[mlo + i]",
             "#if STAGE < 3\n  " + _KEEP.format(a="ure", b="uim", out="p.aud")
             + "\n  return;\n#endif\n"),
            ("  // 3. y[o0 + o]",
             "#if STAGE < 4\n  " + _KEEP.format(a="dd", b="dd", out="p.aud")
             + "\n  return;\n#endif\n"),
        ], ("samples", "xlate", "demod", "full")),
    },
}
# K9's partitioned instance: its cuts `continue` past the round's barrier,
# which holds where every warp's slot is live (the default geometry, timed)
_SUM_X = ("float k0 = 0.f;\n        for (int n = 0; n < kQ; ++n) k0 += xr[n] + "
          "xi[n];\n        if (k0 == 1234.5f) p.out[tid] = k0;")
_FORMS["fir_part.cu"] = {
    "partitioned": ([
        ("        fft<kQ>(xr, xi, xb, tw, t, wr, wi);\n        // X[t + Q k] H_p",
         "#if STAGE < 2\n        {\n        " + _SUM_X
         + "\n        continue;\n        }\n#endif\n"),
        ("      // the inverse transform as the forward one of the conjugate",
         "#if STAGE < 3\n      if (ac[t].x == 1234.5f) p.out[tid] = ac[t].y;"
         "\n      continue;\n#endif\n"),
        ("    // this round's outputs to their rows",
         "#if STAGE < 4\n    " + _KEEP2.format(a="xbuf", out="p.out")
         + "\n    continue;\n#endif\n"),
    ], ("gen", "fft", "inverse", "full")),
}
_KERNELS = {"K9": "fir_source.cu", "K9p": "fir_part.cu",
            "K10": "wbfm_chain.cu", "K12": "wbfm_chain.cu"}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _cut_sources(out: Path) -> dict:
    """The cut copies under ``out``; returns each file's stage names."""
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    names = {}
    for name, forms in _FORMS.items():
        text = (_build.CSRC / name).read_text()
        form = [f for f, (cuts, _) in forms.items()
                if all(text.count(a) == 1 for a, _ in cuts)]
        if not form:
            raise SystemExit(f"{name}: none of the forms {list(forms)} has "
                             f"its anchors here")
        cuts, names[name] = forms[form[0]]
        for anchor, cut in cuts:
            text = text.replace(anchor, cut + anchor)
        (out / name).write_text("#ifndef STAGE\n#define STAGE 99\n#endif\n"
                                + text)
    return names


def _build_stages(out: Path, stages=(1, 2, 3)) -> dict:
    """One library a stage, every nvcc started together; the ptxas lines
    of each build are returned beside it."""
    nvcc = _build._find_nvcc()
    jobs = {}
    for st in stages:
        for name in _FORMS:
            obj = out / f"{Path(name).stem}.s{st}.o"
            jobs[(st, name)] = (obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, f"-DSTAGE={st}", "-c", "-o",
                 str(obj), str(out / name)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    logs = {}
    for (st, name), (obj, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} STAGE={st}:\n{text}")
        logs.setdefault(st, []).append(text)
    libs = {}
    for st in stages:
        so = out / f"libstage{st}.so"
        objs = [str(jobs[(st, n)][0]) for n in _FORMS]
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        *objs], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("fir_tone_launch", "fir_part_launch", "wbfm_chain_launch",
                   "wbfm_live_launch"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[st] = lib
        regs = re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) "
                          r"registers", "".join(logs[st]))
        print(json.dumps({"stage_build": st, "registers": regs}), flush=True)
    return libs


def _wb_plan():
    chan = firdes.low_pass(1.0, WB_FS, 100e3, 30e3)
    rt = firdes.low_pass(1.0, 1.0, 0.45 / WB_RD, 0.1 / WB_RD)
    plan = wbfm_chain.WbfmChainPlan(
        chan, nco.freq_to_dphase(WB_FC, WB_FS), WB_D, rt, WB_RD,
        (WB_FS / WB_D) / (2 * np.pi * WB_DEV))
    return plan, wbfm_chain.wbfm_consts(plan, "cuda")


def _fir_taps(ntaps=FIR_NTAPS):
    taps = firdes.low_pass(1.0, FIR_FS, 0.2 * FIR_FS, 0.05 * FIR_FS,
                           ntaps=ntaps)
    t = torch.from_numpy(taps.astype(np.float32)).cuda()
    make = getattr(fir_source, "fir_tone_consts", None)
    return make(taps, "cuda") if make else t


def _calls():
    """The three kernels at their main paths' shapes: name -> (one-input
    call, rotating call)."""
    plan, consts = _wb_plan()
    taps = _fir_taps()
    dpf = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    dpw = nco.freq_to_dphase(WB_TONE, WB_FS)
    dev = "cuda"
    ph9 = torch.tensor(0x1234567, dtype=torch.int64, device=dev)
    dp9 = torch.tensor(dpf, dtype=torch.int64, device=dev)
    ph12 = torch.tensor(0x89ABCDE, dtype=torch.int64, device=dev)
    dp12 = torch.tensor(dpw, dtype=torch.int64, device=dev)
    amp = torch.tensor(0.8, dtype=torch.float32, device=dev)
    off = torch.tensor(False, device=dev)
    xps = [sources.nco_folded(0x1000 * i, dpw, 0.8, WB_R, dev)
           for i in range(4)]
    carry = torch.zeros(plan.B8, 128, device=dev)

    def k9():
        return fir_source.fir_tone_step(ph9, dp9, amp, off, taps, 1, FIR_R)

    taps_p = _fir_taps(1024)

    def k9p():
        return fir_source.fir_tone_step(ph9, dp9, amp, off, taps_p, 1, FIR_R)

    def k10(xp):
        return wbfm_chain.wbfm_chain_step(xp, carry, plan, consts)[0]

    def k12():
        return wbfm_chain.wbfm_chain_live_step(ph12, dp12, amp, off, plan,
                                               consts, WB_R)
    return {"K9": (k9, rotating(lambda i: (), k9)),
            "K9p": (k9p, rotating(lambda i: (), k9p)),
            "K10": (lambda: k10(xps[0]), rotating(lambda i: (xps[i],), k10)),
            "K12": (k12, rotating(lambda i: (), k12))}


def stages() -> list[dict]:
    out = Path(_build.BUILD_DIR).parent / "stages"
    names = _cut_sources(out)
    libs = _build_stages(out)
    calls = _calls()
    full = _build.lib()
    recs = []
    for kern, src in _KERNELS.items():
        variants = {nm: libs[i + 1] if nm != "full" else full
                    for i, nm in enumerate(names[src])}
        order = list(variants) + list(variants)[::-1]
        ms: dict = {}
        for nm in order:
            _build.lib = (lambda lib=variants[nm]: lib)
            try:
                for mode, fn in zip(("one", "rot"), calls[kern]):
                    ms.setdefault((nm, mode), []).append(graph_ms(fn))
            finally:
                _build.lib = lambda: full
        for (nm, mode), v in ms.items():
            recs.append({"kernel": kern, "stage": nm, "inputs": mode,
                         "us": min(v) * 1e3, "us_all": [t * 1e3 for t in v]})
    return recs


def _outputs() -> dict:
    plan, consts = _wb_plan()
    dpw = nco.freq_to_dphase(WB_TONE, WB_FS)
    res = {}
    for ph in (0x12345678, 0xFFFFF000):
        for first in (True, False):
            xp = sources.nco_folded(ph, dpw, 0.8, WB_R, "cuda")
            carry = torch.zeros(plan.B8, 128, device="cuda")
            if not first:
                carry = sources.nco_folded(ph ^ 0x5555, dpw, 0.8, WB_R,
                                           "cuda")[-plan.B8:].clone()
            for tile, gs in WB_OUT_GEOMS:
                try:
                    a10, _ = wbfm_chain.wbfm_chain_step(xp, carry, plan, consts,
                                                        tile=tile, seg_group=gs)
                    a12 = wbfm_chain.wbfm_chain_live_step(
                        ph, dpw, 0.8, first, plan, consts, WB_R, tile=tile,
                        seg_group=gs)
                except ValueError as e:  # a geometry the tree does not offer
                    print(json.dumps({"skipped": [tile, gs], "why": str(e)}))
                    continue
                key = f"{ph:#x}/{int(first)}/{tile}/{gs}"
                res[f"K10/{key}"] = a10.cpu()
                res[f"K12/{key}"] = a12.cpu()
    taps = _fir_taps()
    dpf = nco.freq_to_dphase(FIR_FREQ, FIR_FS)
    for D in (1, 4):
        res[f"K9/{D}"] = fir_source.fir_tone_step(0x9E3779B9, dpf, 0.8, False,
                                                  taps, D, FIR_R).cpu()
        res[f"K9/1024/{D}"] = fir_source.fir_tone_step(
            0x9E3779B9, dpf, 0.8, False, _fir_taps(1024), D, FIR_R).cpu()
    res.update(_chain_outputs())
    res.update(_noise_outputs())
    torch.cuda.synchronize()
    return res


def _k4(g0, amp=None, layout="rows", n_rows=32768, width=128, **kw):
    """K4 as this tree's noise kernel takes it: the amplitude and the cf32
    layout inside the kernel where it has them, else the blocks' own torch
    ops after it."""
    from newsched_tpu_torch.ops.cuda import noise

    if "layout" in inspect.signature(noise.gaussian_rows).parameters:
        return noise.gaussian_rows(g0, n_rows=n_rows, width=width, seed=0,
                                   device="cuda", amp=amp, layout=layout, **kw)
    r = noise.gaussian_rows(g0, n_rows=n_rows, width=width, seed=0,
                            device="cuda", **kw)
    a = 1 if amp is None else amp
    if layout == "cf32":
        h = width // 2
        re, im = r[:, :h].reshape(-1), r[:, h:].reshape(-1)
        return torch.complex(re, im) if amp is None else \
            torch.complex(re * a, im * a)
    return r if amp is None else r * a


def _fm_graph(kind: str, n_batches, M: int = 64, batch: int = 1 << 21,
              source=None):
    """Config #2 (64 channels, 16 taps an arm, a 65-tap audio FIR by 8,
    batches of 2^21) with its noise source: fused, staged or live; or the
    same at M channels and ``batch`` samples a batch; ``source`` in place
    of the noise source (fused)."""
    from newsched_tpu_torch import models

    D = 8
    at = firdes.low_pass(1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=65)
    return models.fm_channelizer(
        nchans=M, taps_per_arm=16, audio_decim=D, fused=kind != "staged",
        source="live" if kind == "live" else source, batch_size=batch,
        sink="vector" if n_batches else "null",
        n_samples=None if n_batches is None else n_batches * batch // (M * D),
        deviation_frac=1.0 / (2 * np.pi * 0.5), audio_taps=at)


def _noise_outputs() -> dict:
    """K4 in every mode, the noise blocks' outputs and the config #2
    noise graphs' audio."""
    from newsched_tpu_torch.blocks import analog, vector_dsp

    res = {}
    amp = torch.tensor(-0.3, dtype=torch.float32, device="cuda")
    for base in ((1 << 32) - 2, -3):
        g = torch.tensor(base, dtype=torch.int64, device="cuda")
        for layout in ("rows", "cf32"):
            for a in (None, amp):
                key = f"K4/{base}/{layout}/{'amp' if a is not None else 1}"
                res[key] = _k4(g, a, layout, mask_pre=base < 0).cpu()
    for kind, blk, nout in (
            ("planes", vector_dsp.noise_planes_source(64, seed=7), 32768),
            ("cf32", analog.noise_source(seed=7, dtype="cf32"), 1 << 21),
            ("rf32", analog.noise_source(seed=7, dtype="rf32"), 1 << 21)):
        st = blk.init_state(0, nout, "cuda")
        for b in range(2):
            st, o = blk.work(st, {}, {"amplitude": amp}, nout)
            res[f"block/{kind}/{b}"] = o["out"].cpu()
    for kind in ("fused", "staged"):
        fg, blks = _fm_graph(kind, 2)
        fg.run(device="cuda")
        res[f"graph/{kind}"] = torch.from_numpy(np.asarray(blks["sink"].data()))
    return res


def times() -> list[dict]:
    """K4's modes, K9 at 128, 1024 and 6001 taps, K1 at M = 320 and S3 at
    K = 7, by CUDA-graph replay in turns (forward, then backward); the
    graph-mode steps of the config #2 noise graphs, of the staged graph at
    M = 320 and of the 1024-tap live fir_chain."""
    from newsched_tpu_torch import bench, models
    from newsched_tpu_torch.parallel import make_mesh

    g0 = torch.tensor(0, dtype=torch.int64, device="cuda")
    amp = torch.tensor(0.5, dtype=torch.float32, device="cuda")
    dp = torch.tensor(nco.freq_to_dphase(FIR_FREQ, FIR_FS), dtype=torch.int64,
                      device="cuda")
    ph = torch.tensor(7, dtype=torch.int64, device="cuda")
    a8 = torch.tensor(0.8, dtype=torch.float32, device="cuda")
    off = torch.tensor(False, device="cuda")
    calls = {"K4": lambda: _k4(g0),
             "K4 amp": lambda: _k4(g0, amp),
             "K4 cf32 amp": lambda: _k4(g0, amp, "cf32")}
    for nt in (128, 1024, 6001):
        tc = _fir_taps(nt)
        calls[f"K9 {nt} taps"] = (lambda tc=tc: fir_source.fir_tone_step(
            ph, dp, a8, off, tc, 1, FIR_R))
    gen = torch.Generator(device="cuda").manual_seed(320)
    pc = pfb.pfb_consts(pfb.pfb_arm_taps(
        firdes.prototype_channelizer_taps(320, 16), 320), "cuda")
    v = torch.randn(16384 + 15, 640, device="cuda", generator=gen)
    calls["K1 M=320"] = lambda: channelizer.arm_fold_dft(
        v, pc.c2, pc.w2, 16384, fft=pc.fft)
    tabs = fec.viterbi_tables(fec.CC_K7_POLYS, 7, "cuda")
    llr = torch.randn(1024, 518, 2, device="cuda", generator=gen)
    calls["S3 K=7"] = lambda: kfec.viterbi_frames(llr, tabs, 7, True)
    z = dict(dtype=torch.float32, device="cuda")
    for M in (128, 256, 320, 448, 512, 1024):  # the chains, 16384 rows
        W = 2 * M
        c = np.ascontiguousarray(pfb.pfb_arm_taps(
            firdes.prototype_channelizer_taps(M, 16), M)[::-1, ::-1].T)
        cc = fm_chain.fm_chain_consts(c, firdes.low_pass(
            1.0, 1.0, 0.05, 0.0125, ntaps=65), "cuda")
        vb = torch.randn(16384, W, device="cuda", generator=gen) * 0.5
        st = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
              torch.zeros(64, W, **z))
        calls[f"K3 M={M}"] = (lambda vb=vb, st=st, cc=cc:
                              fm_chain.fm_chain_step_planes(vb, *st, cc, 8,
                                                            0.5))
        calls[f"K5 M={M}"] = (lambda st=st, cc=cc: fm_chain.fm_chain_gen_step(
            g0, amp, *st, cc, 8, 0.5, 16384))
        calls[f"K6 M={M}"] = (lambda cc=cc: fm_chain.fm_chain_gen_warm_step(
            g0, amp, cc, 8, 0.5, 4096, warm=512))
        try:
            calls[f"K3 M={M}"]()
        except ValueError as e:  # a width the tree refuses
            print(json.dumps({"skipped": f"chains M={M}", "why": str(e)[:200]}))
            for k in ("K3", "K5", "K6"):
                del calls[f"{k} M={M}"]
    ms: dict = {}
    for name in list(calls) + list(calls)[::-1]:
        ms.setdefault(name, []).append(graph_ms(calls[name]))
    recs = [{"kernel": k, "ms": min(v), "ms_all": v} for k, v in ms.items()]
    cells = {"#2 fused noise": (lambda: _fm_graph("fused", None)[0], 1 << 21),
             "#2 staged": (lambda: _fm_graph("staged", None)[0], 1 << 21),
             "#2 staged M=320": (lambda: _fm_graph(
                 "staged", None, 320, 16384 * 320)[0], 16384 * 320),
             "#2 staged M=512": (lambda: _fm_graph(
                 "staged", None, 512, 16384 * 512)[0], 16384 * 512),
             "#2 staged M=1024": (lambda: _fm_graph(
                 "staged", None, 1024, 16384 * 1024)[0], 16384 * 1024),
             "#2 live": (lambda: _fm_graph("live", None)[0], 1 << 21),
             "#2 live 4 shards": (lambda: _fm_graph("live", None)[0], 1 << 21,
                                  4),
             "#2 live 8 shards": (lambda: _fm_graph("live", None)[0], 1 << 21,
                                  8),
             "#0 live 1024 taps": (lambda: models.fir_chain(
                 n_samples=10_000_000, fs=FIR_FS, ntaps=1024, frequency=FIR_FREQ,
                 batch_size=1 << 21, sink="null", source="live")[0], 1 << 21)}
    for label, (build, n_in, *mesh) in cells.items():
        try:
            run = bench.graph_run(build(), "cuda",
                                  mesh=make_mesh(mesh[0]) if mesh else None)
            sps = bench.timed_two_point(run, label, n_in, n_best=3, k1=16,
                                        k2=64)
        except (ValueError, RuntimeError) as e:  # a width the tree refuses
            recs.append({"cell": label, "error": str(e)[:200]})
            continue
        recs.append({"cell": label, "graph_mode_ms": n_in / sps * 1e3})
    return recs


def _chain_outputs() -> dict:
    """K3 (two carried batches, tiles 128 and 64, and a time shard with
    warm > 0), K3p, K3ag (ag = 2), K5 (two batches from stream start) and
    K6 (a shard of 8192 rows) at the flagship's M = 64, 16 taps an arm, a
    65-tap audio FIR decimating by 8, on seeded rows of 32768."""
    M, L, A, D, n = 64, 16, 65, 8, 32768
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=A)
    c = np.ascontiguousarray(pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T)
    consts = fm_chain.fm_chain_consts(c, at, "cuda")
    g = torch.Generator(device="cuda").manual_seed(64)
    rows = torch.randn(2 * n, 2 * M, device="cuda", generator=g) * 0.5
    z = dict(dtype=torch.float32, device="cuda")
    res = {}

    def k3(key, **kw):
        halo, prev = torch.zeros(16, 2 * M, **z), torch.zeros(1, 2 * M, **z)
        tail = torch.zeros(A - 1, 2 * M, **z)
        for b in range(2):
            vb = rows[b * n:(b + 1) * n]
            aud, prev, tail = fm_chain.fm_chain_step_planes(
                vb, halo, prev, tail, consts, D, 0.5, **kw)
            for name, t in (("aud", aud), ("prev", prev), ("tail", tail)):
                res[f"{key}/{b}/{name}"] = t.cpu()
            halo = vb[-16:].contiguous()

    k3("K3/128", tile=128)
    k3("K3/64", tile=64)
    k3("K3p", pipelined=True)
    pick = fm_chain._pick_audio_groups
    fm_chain._pick_audio_groups = lambda tile, decim, A: 2
    try:
        k3("K3ag2")
    finally:
        fm_chain._pick_audio_groups = pick
    warm = 512
    zp, zt = torch.zeros(1, 2 * M, **z), torch.zeros(A - 1, 2 * M, **z)
    res["K3/warm"] = fm_chain.fm_chain_step_planes(
        rows[n:].contiguous(), rows[n - warm - 16:n].contiguous(), zp, zt,
        consts, D, 0.5, warm=warm, tile=128)[0].cpu()
    amp = torch.tensor(0.5, **z)
    carry, prev, tail = torch.zeros(16, 2 * M, **z), zp, zt
    for b in range(2):
        grp = torch.tensor(b * n // 64, dtype=torch.int64, device="cuda")
        aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
            grp, amp, carry, prev, tail, consts, D, 0.5, n)
        res[f"K5/{b}/aud"] = aud.cpu()
        res[f"K5/{b}/carry"] = carry.cpu()
    grp = torch.tensor(0, dtype=torch.int64, device="cuda")
    res["K6"] = fm_chain.fm_chain_gen_warm_step(
        grp, amp, consts, D, 0.5, 8192, warm=512, goff=3 * 8192 // 64).cpu()
    halo, prev = torch.zeros(16, 2 * M, **z), torch.zeros(1, 2 * M, **z)
    tail = torch.zeros(A - 1, 2 * M, **z)
    for variant in ablate.VARIANTS:
        res[f"ablate/{variant}"] = ablate.fm_chain_ablate(
            rows[:n], halo, prev, tail, consts, D, 0.5, variant)[0].cpu()
    res.update(_wide_chain_outputs())
    res.update(_k1_outputs())
    return res


def _k1_outputs() -> dict:
    """K1 (``arm_fold_dft`` on its FFT table) at M = 64 .. 448 on 8192
    seeded rows of a real channelizer's taps, 16 an arm."""
    res = {}
    for M in range(64, 449, 64):
        taps = firdes.prototype_channelizer_taps(M, 16)
        pc = pfb.pfb_consts(pfb.pfb_arm_taps(taps, M), "cuda")
        g = torch.Generator(device="cuda").manual_seed(M + 7)
        v = torch.randn(8192 + 15, 2 * M, device="cuda", generator=g)
        res[f"K1 M={M}"] = channelizer.arm_fold_dft(v, pc.c2, pc.w2, 8192,
                                                    fft=pc.fft).cpu()
    return res


def _wide_chain_width(M: int, L: int, A: int, D: int, n: int) -> dict:
    """_wide_chain_outputs' chain records at M channels."""
    W = 2 * M
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    res = {}
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=A)
    c = np.ascontiguousarray(pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T)
    consts = fm_chain.fm_chain_consts(c, at, "cuda")
    g = torch.Generator(device="cuda").manual_seed(M)
    rows = torch.randn(2 * n, W, device="cuda", generator=g) * 0.5
    for key, ag in (("K3", 1), ("K3ag2", 2)):
        pick = fm_chain._pick_audio_groups
        fm_chain._pick_audio_groups = lambda tile, decim, A, ag=ag: ag
        try:
            halo, prev = torch.zeros(16, W, **z), torch.zeros(1, W, **z)
            tail = torch.zeros(A - 1, W, **z)
            for b in range(2):
                vb = rows[b * n:(b + 1) * n]
                aud, prev, tail = fm_chain.fm_chain_step_planes(
                    vb, halo, prev, tail, consts, D, 0.5)
                for name, t in (("aud", aud), ("prev", prev),
                                ("tail", tail)):
                    res[f"{key} M={M}/{b}/{name}"] = t.cpu()
                halo = vb[-16:].contiguous()
        finally:
            fm_chain._pick_audio_groups = pick
    grp = torch.tensor(0, dtype=torch.int64, device="cuda")
    zs = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
          torch.zeros(A - 1, W, **z))
    k5 = fm_chain.fm_chain_gen_step(grp, amp, *zs, consts, D, 0.5, n)
    for name, t in zip(("aud", "prev", "tail", "carry"), k5):
        res[f"K5 M={M}/{name}"] = t.cpu()
    res[f"K6 M={M}"] = fm_chain.fm_chain_gen_warm_step(
        grp, amp, consts, D, 0.5, n // 4, warm=512,
        goff=3 * (n // 4) // 64).cpu()
    return res


def _wide_chain_outputs() -> dict:
    """K3 (two carried batches), K3ag (ag = 2), K5 and K6 (a shard of 4096
    rows at shard 3) at M = 128 .. 448, 512 and 1024 on seeded rows of
    16384 (a width the tree refuses skipped), and S3 on
    256 seeded frames of 512 bits at K = 3, 7, 11 and 12 (on 16 frames at
    K = 15)."""
    L, A, D, n = 16, 65, 8, 16384
    res = {}
    for M in (128, 192, 256, 320, 384, 448, 512, 1024):
        try:
            res.update(_wide_chain_width(M, L, A, D, n))
        except ValueError as e:  # a width the tree refuses
            print(json.dumps({"skipped": f"chains M={M}", "why": str(e)[:200]}))
    gen = torch.Generator(device="cuda").manual_seed(511)
    for polys, K in ((fec.CC_K7_POLYS, 7), ((0o7, 0o5), 3),
                     ((0o2565, 0o3753), 11), ((0o4037, 0o5741), 12),
                     ((0o46321, 0o51271), 15)):
        tabs = fec.viterbi_tables(polys, K, "cuda")
        frames = 16 if K == 15 else 256
        llr = torch.randn(frames, 512 + K - 1, 2, device="cuda", generator=gen)
        for term in (True, False):
            res[f"S3 K={K}/{int(term)}"] = kfec.viterbi_frames(
                llr, tabs, K, term).cpu()
    return res


def outputs(argv) -> list[dict]:
    res = _outputs()
    if argv[:1] == ["--save"]:
        torch.save(res, argv[1])
        return [{"saved": len(res), "to": argv[1]}]
    ref = torch.load(argv[1])
    recs = []
    for key, v in res.items():
        # a geometry one tree offers and the other not has no pair
        if key not in ref:
            recs.append({"key": key, "unpaired": True})
            continue
        r = ref[key]
        recs.append({"key": key, "bit_equal": bool(torch.equal(v, r)),
                     "max_abs_diff": float((v - r).abs().max()),
                     "max_abs": float(r.abs().max())})
    return recs


# -- the sharded hooks' per-shard loops (cut copies) ---------------------
#
# How K3 at warm > 0 (the fused replay), K10 (#1 fused), K12 (#1 live)
# and K9 (#0 live) ran on a mesh before one launch took every shard of a
# batch: a launch a shard from a Python loop, then a torch.cat of the
# shards. Kept only to time the two forms in one call (``sharded``,
# chip_smoke.py phase 29) and to hold them equal in the CPU tests; no
# graph's path takes them but under ``shard_loops()``.

def _loop_step_planes(self, xrows, state):
    """``ShardedFMChannelizer.step_planes`` on n > 1 shards: K3 a shard,
    each after a ``time_halo`` of warm + H8 rows."""
    from newsched_tpu_torch.parallel.channelizer import kernel_tile
    from newsched_tpu_torch.parallel.halo import time_halo

    if self.n_dev == 1:
        raise ValueError("the per-shard loop is the sharded step's")
    n_rows = int(xrows.shape[0])
    tile, warm = self._planes_setup(n_rows)
    A, L = len(self.audio_taps), self.arm_taps.shape[1]
    kt = kernel_tile(tile, self.audio_decim,
                     max(fm_chain._round8(L - 1), A - 1))
    consts = self._dev_consts(xrows.device)[1]
    xrows = xrows.contiguous()
    hr = int(state.carry.shape[0]) // self.n_dev
    segs = list(xrows.split(n_rows // self.n_dev))
    halos, recv = time_halo(segs, list(state.carry.split(hr)))
    auds = [fm_chain.fm_chain_step_planes(
        s, h, state.prev, state.tail, consts, self.audio_decim,
        self.demod_gain, warm=warm, tile=kt,
        precision=self.chain_precision)[0] for s, h in zip(segs, halos)]
    return torch.cat(auds), state._replace(carry=torch.cat(recv))


def _loop_wbfm_fused(self, state, ins, params, nout, mesh, axis):
    """``wbfm_rcv_fused.work_sharded``: a fold and K10 a shard, its
    junction the left neighbour's bottom B8 folded rows."""
    nd = mesh.shape[axis]
    x = ins["in"]
    consts = self.consts(x.device)
    auds, bots = [], []
    for d, seg in enumerate(x.chunk(nd)):
        xp = wbfm_chain.fold_planes(seg)
        aud, bot = wbfm_chain.wbfm_chain_step(
            xp, bots[-1] if d else state["carry"], self.plan, consts,
            tile=self.tile)
        auds.append(wbfm_chain.unfold_audio(aud))
        bots.append(bot)
    return {"carry": bots[-1]}, {"out": torch.cat(auds)}


def _loop_wbfm_live(self, state, ins, params, nout, mesh, axis):
    """``wbfm_live_source.work_sharded``: K12 a shard at its phase
    offset."""
    from newsched_tpu_torch.blocks.analog import _live_advance

    nd = mesh.shape[axis]
    S, D, Rd = wbfm_chain.S, self.plan.D, self.plan.Rd
    n_loc = int(nout) * D * Rd // nd
    ph, dp, a = state["phase"], params["dphase"], params["amplitude"]
    consts = self.consts(a.device)
    auds = [wbfm_chain.unfold_audio(wbfm_chain.wbfm_chain_live_step(
        ph, dp, a, state["first"], self.plan, consts, n_loc // S,
        tile=self.tile, shard=d)) for d in range(nd)]
    return (_live_advance(state, dp, int(nout) * D * Rd),
            {"out": torch.cat(auds)})


def _loop_fir_tone(self, state, ins, params, nout, mesh, axis):
    """``fir_tone_source.work_sharded``: K9 a shard at its phase offset."""
    from newsched_tpu_torch.blocks.analog import _live_advance

    nd = mesh.shape[axis]
    R_loc = self._fold_rows(int(nout) // nd)
    ph, dp, a = state["phase"], params["dphase"], params["amplitude"]
    taps = self.dev_taps(a.device)
    outs = [fir_source.unfold_complex(fir_source.fir_tone_step(
        ph, dp, a, state["first"], taps, self.decim, R_loc,
        tile=self.tile, shard=d)) for d in range(nd)]
    return (_live_advance(state, dp, int(nout) * self.decim),
            {"out": torch.cat(outs)})


@contextlib.contextmanager
def shard_loops():
    """The four hooks' per-shard loops in place of their one launch, for
    the graphs built and run inside."""
    from newsched_tpu_torch.blocks import analog
    from newsched_tpu_torch.parallel.channelizer import ShardedFMChannelizer

    cuts = ((ShardedFMChannelizer, "step_planes", _loop_step_planes),
            (analog.wbfm_rcv_fused, "work_sharded", _loop_wbfm_fused),
            (analog.wbfm_live_source, "work_sharded", _loop_wbfm_live),
            (analog.fir_tone_source, "work_sharded", _loop_fir_tone))
    kept = [(cls, name, cls.__dict__[name]) for cls, name, _ in cuts]
    try:
        for cls, name, fn in cuts:
            setattr(cls, name, fn)
        yield
    finally:
        for cls, name, fn in kept:
            setattr(cls, name, fn)


SHARDS = (4, 8)  # the logical shards of the sharded graphs


def sharded_cells() -> dict:
    """The sharded graphs' cells at full width, each with a null sink: the
    builder of its graph and its input samples a batch. #2 fused replay
    (K3 at warm > 0 sharded) on seeded planes rows, #1 fused (K8 -> K10)
    and #1 live (K12) on config #1's tone, #0 live (K9) on config #0's."""
    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import analog, general

    gen = torch.Generator().manual_seed(29)
    rows = (torch.randn(32768, 128, generator=gen) * 0.5).numpy()

    def wb(live):
        fg, blks = models.wbfm_receiver(
            fs=WB_FS, center_freq=WB_FC, quad_rate_decim=WB_D,
            audio_decim=(1, WB_RD), deviation=WB_DEV,
            source="live" if live else analog.sig_source(
                WB_FS, "complex", frequency=WB_TONE),
            batch_size=64 * WB_R, sink="null", fused=True, n_samples=None)
        if live:
            blks["source"].set_frequency(WB_TONE)
        return fg

    return {
        "#2 fused replay": (lambda: _fm_graph(
            "fused", None, source=general.vector_source(rows, repeat=True))[0],
            1 << 21),
        "#1 fused": (lambda: wb(False), 64 * WB_R),
        "#1 live": (lambda: wb(True), 64 * WB_R),
        "#0 live": (lambda: models.fir_chain(
            n_samples=10_000_000, fs=FIR_FS, ntaps=FIR_NTAPS,
            frequency=FIR_FREQ, batch_size=64 * FIR_R, sink="null",
            source="live")[0], 64 * FIR_R),
    }


def sharded_steps(cells: dict | None = None, shards=SHARDS,
                  device="cuda") -> list[dict]:
    """Graph-mode steps (the bench's two-point fit, k = 16 and 64, CUDA
    events) of each sharded cell unsharded and at each shard count, in one
    launch a batch and in the per-shard loop (``shard_loops``), in turns:
    forward, then backward. One record a cell and form: its best and every
    ms a step."""
    from newsched_tpu_torch import bench
    from newsched_tpu_torch.parallel import make_mesh

    cells = sharded_cells() if cells is None else cells
    runs = [(cell, n, form) for cell in cells for n in (1, *shards)
            for form in (("one launch",) if n == 1 else ("one launch", "loop"))]
    ms: dict = {}
    for cell, n, form in runs + runs[::-1]:
        build, n_in = cells[cell]
        with (shard_loops() if form == "loop" else contextlib.nullcontext()):
            run = bench.graph_run(
                build(), device,
                mesh=make_mesh(n, device=device) if n > 1 else None)
            sps = bench.timed_two_point(run, f"{cell}, {n} shards, {form}",
                                        n_in, n_best=3, k1=16, k2=64)
        ms.setdefault((cell, n, form), []).append(n_in / sps * 1e3)
    return [{"cell": cell, "shards": n, "form": form, "ms": min(v),
             "ms_all": v} for (cell, n, form), v in ms.items()]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("stages: no CUDA device", file=sys.stderr)
        return 2
    print(_card(), flush=True)
    recs = (stages() if argv[:1] == ["stages"] else
            times() if argv[:1] == ["times"] else
            sharded_steps() if argv[:1] == ["sharded"] else outputs(argv[1:]))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
