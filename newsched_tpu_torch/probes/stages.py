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
    PYTHONPATH=<tree> python3 <this file> split
    PYTHONPATH=<tree> python3 <this file> wide [M ...]
    PYTHONPATH=<tree> python3 <this file> s3 [--geometries]
    PYTHONPATH=<tree> python3 <this file> s3split
    PYTHONPATH=<tree> python3 <this file> k3p [--split]
    PYTHONPATH=<tree> python3 <this file> scansplit

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
``noise_source`` cf32 and rf32) and the audio of the config #2 fused-noise,
staged, live and 4-shard live graphs (two batches, graph mode), and K5
at tiles 64 and 256 and K6 over 4 and 8 shards of a batch at M = 64, and
saves them, or compares
them with a saved run: each record says whether the two are bit-equal and
their largest difference. A tree whose noise kernel takes no amplitude
gets its blocks' own ``r * amp`` and torch.complex build.

``times`` times, alternating, by CUDA-graph replay: K4 at 32768 x 128
alone, with the amplitude and as the cf32 stream (in a tree without them,
the kernel and the blocks' torch ops after it), and with the amplitude at
16384 x 2M for M = 512 and 1024; K3 and K5 at M = 64 on
its 32768 rows and K6 over their 4 and 8 shards; K9 at 128, 1024 and 6001
taps; K1 at M = 320 on 16384 rows (whichever instance the tree routes
that width to), S3 at 1024 frames of 512 bits, K = 7 (the tree's
default instance), K3 and K5 at M = 128, 256, 320, 448, 512 and 1024
on 16384 rows and K6 on 4096 (a width the tree refuses left out); and
the graph-mode steps of the config #2 fused-noise, staged and
live graphs, the live graph on 4 and 8 shards, the staged graph at M =
320, 512 and 1024 (16384 rows a batch; a width the tree refuses is
recorded as its error) and the live fir_chain at 1024 taps (the bench's
two-point fit).

``wide`` takes K3, K5 and K6 (over 4 shards) at M = 256, 448 and 1024
(16384 rows) apart: cut copies of ``fm_chain.cu`` (``_WIDE_FORMS``, built
under ``build/wide/``) stop after the input rows, the fold, the FFT and
the demod, each timed beside the whole kernel.

``split`` takes K5 at the flagship's M = 64 (32768 rows) apart beside
K4: K3 on K4's rows (the chain on a loaded window) and its window alone,
K5 and K6 over 4 shards whole and their window alone (made, not
folded), the window alone from ``fm_chain.cu`` cut after it
(``_WINDOW_CUT``, built under ``build/split/``); in a tree whose K5 and
K6 take the junction handoff, with it and without it.

``s3`` decodes S3's routes (``S3_TIME_ROUTES``: the FEC link's K = 7 and
11, the 16384-bit frames, rate 1/5, K = 12, 15-18) under the tree's
``csrc/viterbi.cu`` built alone, each against the plain version on the
card, and times them (``--geometries``: other states a thread and blocks
a frame of the block and cluster instance); ``s3split`` times cut copies
of the kernel those routes take (``_S3_FORMS``); ``k3p`` holds K3p
against K3 bit for bit and times both (``--split``: K3p's fold and demod
groups' work cut, ``_K3P_CUTS``). Run under two trees in turns to compare
them.

``scansplit`` times S4 at config #1's de-emphasis (104448 rf32 samples)
and S5 at the QPSK link's batch (2^20 cf32) whole and as cut copies of
``csrc/scan.cu`` (``_SCAN_CUTS``, cumulative, built alone under
``build/split_scan/``): without the look-back (each tile starts from the
carried state), then without the aggregates' publication, then with
blockIdx in place of the ticket; beside a torch copy of the same bytes.

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
import threading
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


# K3's, K5's and K6's tile routine at 128 lanes (csrc/fm_chain.cu
# chain_tile) cut after its window, as K3's kDmaOnly variant: STAGE 1
# writes the window's rows o * decim as the audio and returns, so K3 reads
# its window and K5 and K6 make theirs, and nothing of the chain runs
_WINDOW_CUT = ("    if constexpr (kV == kDmaOnly) {",
               "#if STAGE < 2\n"
               "    for (int idx = tid; idx < p.T / p.decim * M; idx += kThreads) {\n"
               "      const int o = idx / M, m = idx % M;\n"
               "      p.aud[((long long)t0 / p.decim + o) * M + m] =\n"
               "          buf[(A + L - 1 + o * p.decim) * W + m];\n"
               "    }\n"
               "    return;\n"
               "#endif\n")


def _gen_registers(log: str) -> list:
    """(kernel, registers) of K5's and K6's instances in a build log."""
    return re.findall(r"Function properties for \S*?(fm_chain_gen\w*?Li\d+ELi\d+E)"
                      r"[\s\S]*?Used (\d+) registers", log)


def _window_cut_lib(out: Path) -> ctypes.CDLL:
    """``csrc/fm_chain.cu`` cut after the window (``_WINDOW_CUT``, STAGE
    1), built alone under ``out``: the chain kernels' launchers."""
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    text = (_build.CSRC / "fm_chain.cu").read_text()
    anchor, cut = _WINDOW_CUT
    if text.count(anchor) != 1:
        raise SystemExit("fm_chain.cu: the window cut's anchor is not there "
                         "once")
    (out / "fm_chain.cu").write_text("#define STAGE 1\n"
                                     + text.replace(anchor, cut + anchor))
    so = out / "libwindow.so"
    log = _build._compile([out / "fm_chain.cu"], so)
    print(json.dumps({"window_cut_build": str(so),
                      "registers": _gen_registers(log)}), flush=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("fm_chain"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def split() -> list[dict]:
    """K5 at the flagship's M = 64 (32768 rows, the default tile) taken
    apart, beside K4 with the amplitude: K3 on K4's rows (the chain on a
    loaded window) and its window alone, K5 whole and its generation
    alone (the window made, ``_WINDOW_CUT``), K6 over the 4 shards of the
    batch whole and alone; in a tree with the junction handoff
    (``fm_chain._handoff_buffers``) K5 and K6 with it and without it (the
    wrapper given no handoff buffers, so each block generates its whole
    window). By CUDA-graph replay, forward then backward; each record the
    best."""
    M, L, A, D, n = 64, 16, 65, 8, 32768
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=A)
    c = np.ascontiguousarray(pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T)
    consts = fm_chain.fm_chain_consts(c, at, "cuda")
    z = dict(dtype=torch.float32, device="cuda")
    g0 = torch.tensor(5, dtype=torch.int64, device="cuda")
    amp = torch.tensor(0.5, **z)
    rows = _k4(g0, amp)
    st = (torch.zeros(16, 2 * M, **z), torch.zeros(1, 2 * M, **z),
          torch.zeros(A - 1, 2 * M, **z))
    calls = {"K4 amp": lambda: _k4(g0, amp),
             "K3": lambda: fm_chain.fm_chain_step_planes(rows, *st, consts, D,
                                                         0.5),
             "K5": lambda: fm_chain.fm_chain_gen_step(g0, amp, *st, consts, D,
                                                      0.5, n),
             "K6 4 shards": lambda: fm_chain.fm_chain_gen_warm_step(
                 g0, amp, consts, D, 0.5, n // 4, warm=512, nd=4)}
    bufs = getattr(fm_chain, "_handoff_buffers", None)
    forms = (True, False) if bufs else (None,)
    box: dict = {}  # the cut builds while the library does
    th = threading.Thread(target=lambda: box.setdefault(
        "lib", _window_cut_lib(Path(_build.BUILD_DIR).parent / "split")))
    th.start()
    full = _build.lib()
    th.join()
    window = box["lib"]
    if _build.build().log:
        print(json.dumps({"build": "library",
                          "registers": _gen_registers(_build.build().log)}),
              flush=True)
    runs = []  # (name, call, library, handoff)
    for name, fn in calls.items():
        for ho in (forms if name[:2] in ("K5", "K6") else (None,)):
            tag = name if ho is None else \
                f"{name} {'handoff' if ho else 'whole windows'}"
            runs.append((tag, fn, full, ho))
            if name != "K4 amp":
                runs.append((tag + " window alone", fn, window, ho))
    ms: dict = {}
    try:
        for tag, fn, lib, ho in runs + runs[::-1]:
            _build.lib = (lambda lib=lib: lib)
            if ho is not None:
                fm_chain._handoff_buffers = (
                    bufs if ho else lambda plan, w, dev: (None, None))
            ms.setdefault(tag, []).append(graph_ms(fn))
    finally:
        _build.lib = lambda: full
        if bufs:
            fm_chain._handoff_buffers = bufs
    recs = [{"kernel": k, "ms": min(v), "ms_all": v} for k, v in ms.items()]
    if bufs:
        recs.append({"plan": fm_chain.gen_plan(2 * M, 128, n // 128, A,
                                               L)._asdict()})
    return recs


# The chains past 64 channels cut into stages (``wide``): for each form of
# csrc/fm_chain.cu's wide routines, (anchor, text put before it, text put
# after it) a cut behind STAGE; the cuts are cumulative, each leaving the
# stages below it: 1 the input rows (loaded, or made), 2 + the fold, 3 +
# the FFT, 4 + the demod, then the audio FIR (the untouched build).
# "rebuild": each block rebuilds its junction (chain_tile_stream, M = 128
# .. 448, and chain_tile_wide past it); "handoff": the blocks take their
# junction from the block before (chain_tile_wide, every M past 64), so
# every cut keeps the slots and flags the blocks hand over.
_WIDE_STAGES = ("rows", "fold", "fft", "demod", "full")
_WIDE_FORMS = {
    "rebuild": [
        # chain_tile_wide
        ("#pragma unroll\n        for (int e = 0; e < kWideRows; ++e) {\n"
         "          float acc = 0.f;\n          if (e < n && t_first + e >= t_min) {\n"
         "            acc = c[0] * x[e];",
         "#if STAGE < 2\n#pragma unroll\n        for (int e = 0; e < kWideRows; ++e)\n"
         "          tile[e * W + sw(e, k)] = x[e] + x[e + kFoldL - 1];\n"
         "        continue;\n#endif\n", ""),
        ("    // 2. Y of the pass's rows (past n: zeros)\n",
         "#if STAGE < 3\n    continue;\n#endif\n", ""),
        ("    // 3. demod and audio, position by position, rows r0+hi down to r0+1;",
         "#if STAGE < 4\n    continue;\n#endif\n", ""),
        ("        // the outputs o with A + o*decim - (A-1) <= jj <= A + o*decim",
         "#if STAGE < 5\n        if (v == 1234.5f) oacc[pos] = v;\n"
         "        continue;\n#endif\n", ""),
        # chain_tile_stream
        ("    if (L == kFoldL)\n      fold_pass<W, kFoldL>(",
         "#if STAGE < 2\n    continue;\n#endif\n", ""),
        ("    // 2. Y of the 32 rows (past n: zeros)\n",
         "#if STAGE < 3\n    continue;\n#endif\n", ""),
        ("    // 3. demod of rows r0+1 .. r0+hi into audb;",
         "#if STAGE < 4\n    continue;\n#endif\n", ""),
        ("    // 4. Y[r0] for the pass below; the audio outputs take rows",
         "#if STAGE < 5\n    continue;\n#endif\n", ""),
    ],
    "handoff": [
        ("#pragma unroll\n      for (int e = 0; e < kWideRows; ++e) {\n"
         "        float acc = 0.f;\n        if (s0 + e0 + e >= t_min) {",
         "#if STAGE < 2\n#pragma unroll\n      for (int e = 0; e < kWideRows; ++e)\n"
         "        tile[(e0 + e) * W + sw(e0 + e, k)] = x[e] + x[e + kFoldL - 1];\n"
         "      continue;\n#endif\n", ""),
        ("    fft_wide<kP, kT, kR>(tile, p, pl, tb);\n", "#if STAGE >= 3\n",
         "#endif\n"),
        ("            v[i] = demod<kFull>(ar, ai, yr, yi, p);\n",
         "#if STAGE < 4\n            v[i] = ar + yi;\n#else\n", "#endif\n"),
        ("  const int A = p.A, decim = p.decim, u_lo = u_hi - cnt + 1;\n",
         "#if STAGE < 5\n  if (v[0] == 1234.5f) oacc[pos] = v[cnt - 1];\n"
         "  return;\n#endif\n", ""),
    ],
}
WIDE_SPLIT_M = (256, 448, 1024)  # config #4's width, the widest stream
# instance's and the widest


def _wide_cut_libs(out: Path) -> tuple:
    """``csrc/fm_chain.cu`` cut at each stage of its wide routines
    (``_WIDE_FORMS``, whichever form has all its anchors once), built
    under ``out``, one nvcc a stage, all at once; the form's name and the
    libraries, STAGE 1 .. 4."""
    out.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    text = (_build.CSRC / "fm_chain.cu").read_text()
    form = next((f for f, cuts in _WIDE_FORMS.items()
                 if all(text.count(a) == 1 for a, _, _ in cuts)), None)
    if form is None:
        raise SystemExit("fm_chain.cu: no form of the wide cuts has all its "
                         "anchors here once")
    for anchor, before, after in _WIDE_FORMS[form]:
        text = text.replace(anchor, before + anchor + after)
    libs, logs, errors = {}, {}, []

    def build(st):
        try:
            build_one(st)
        except BaseException as e:  # raised again by the caller's thread
            errors.append(f"STAGE {st}: {e}")

    def build_one(st):
        src = out / f"fm_chain_s{st}.cu"
        src.write_text(f"#define STAGE {st}\n" + text)
        so = out / f"libwide{st}.so"
        logs[st] = _build._compile([src], so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _build.SIGNATURES.items():
            if name.startswith("fm_chain"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[st] = lib

    threads = [threading.Thread(target=build, args=(st,)) for st in (1, 2, 3, 4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors or len(libs) != 4:
        raise SystemExit("fm_chain.cu: a stage's cut copy did not build:\n"
                         + "\n".join(errors))
    print(json.dumps({"wide_cut_form": form, "registers": re.findall(
        r"Function properties for \S*?(fm_chain_\w*?kernel\w*)[\s\S]*?Used "
        r"(\d+) registers", logs[4])}), flush=True)
    return form, libs


def wide(argv=()) -> list[dict]:
    """K3, K5 and K6 (over the 4 shards of the batch) at WIDE_SPLIT_M (or
    the widths given) on
    16384 rows (16 taps an arm, a 65-tap audio FIR by 8) taken apart into
    the stages of ``_WIDE_STAGES``: each stage's cut copy of
    ``csrc/fm_chain.cu`` (``_wide_cut_libs``, built under
    ``build/wide/``) beside the tree's own build, by CUDA-graph replay,
    forward then backward; each record the best of the two."""
    L, A, D, n = 16, 65, 8, 16384
    z = dict(dtype=torch.float32, device="cuda")
    g0 = torch.tensor(0, dtype=torch.int64, device="cuda")
    amp = torch.tensor(0.5, **z)
    box: dict = {}  # the cuts build while the library does

    def cuts():
        try:
            box["form"], box["libs"] = _wide_cut_libs(
                Path(_build.BUILD_DIR).parent / "wide")
        except BaseException as e:  # raised again below
            box["error"] = e

    th = threading.Thread(target=cuts)
    th.start()
    full = _build.lib()
    th.join()
    if "error" in box:
        raise box["error"]
    libs = {**{_WIDE_STAGES[st - 1]: lib for st, lib in box["libs"].items()},
            "full": full}
    calls = {}
    for M in [int(a) for a in argv] or WIDE_SPLIT_M:
        W = 2 * M
        c = np.ascontiguousarray(pfb.pfb_arm_taps(
            firdes.prototype_channelizer_taps(M, L), M)[::-1, ::-1].T)
        cc = fm_chain.fm_chain_consts(c, firdes.low_pass(
            1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=A), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(M)
        vb = torch.randn(n, W, device="cuda", generator=gen) * 0.5
        st = (torch.zeros(16, W, **z), torch.zeros(1, W, **z),
              torch.zeros(A - 1, W, **z))
        calls[f"K3 M={M}"] = (lambda vb=vb, st=st, cc=cc:
                              fm_chain.fm_chain_step_planes(vb, *st, cc, D,
                                                            0.5))
        calls[f"K5 M={M}"] = (lambda st=st, cc=cc: fm_chain.fm_chain_gen_step(
            g0, amp, *st, cc, D, 0.5, n))
        calls[f"K6 M={M} 4 shards"] = (
            lambda cc=cc: fm_chain.fm_chain_gen_warm_step(
                g0, amp, cc, D, 0.5, n // 4, warm=512, nd=4))
    ms: dict = {}
    order = [(k, s) for k in calls for s in _WIDE_STAGES]
    try:
        for k, s in order + order[::-1]:
            _build.lib = (lambda lib=libs[s]: lib)
            ms.setdefault((k, s), []).append(graph_ms(calls[k]))
    finally:
        _build.lib = lambda: full
    return [{"kernel": k, "stage": s, "form": box["form"], "ms": min(v),
             "ms_all": v} for (k, s), v in ms.items()]


# S3's routes that the block instance takes (chip_smoke.py S3_ROUTES): name,
# code, K, frames of 512 bits
S3_SPLIT_ROUTES = (
    ("K=12", (0o4037, 0o5741), 12, 256),
    ("n=5", (0o171, 0o133, 0o165, 0o117, 0o127), 7, 256),
    ("K=16", (0o152711, 0o126723), 16, 16),
)
# The cuts of S3's kernels that the block routes take, each form's (anchor,
# text put before it, text put after it) behind its own macro, and the
# variants timed (name, macros; THREADS the old form's threads a frame).
# "block-a-frame": csrc/viterbi.cu viterbi_kernel, the design before the
# redesign (run against a tree that has it); "acs": viterbi_acs_kernel.
_S3_FORMS = {
    "block-a-frame": ({
        # no max: g stays 0 and no warp maximum is reduced or stored
        "CUT_MAX": [
            ("      g = wm[0];\n      for (int w = 1; w < NWt; ++w) g = fmaxf(g, wm[w]);\n",
             "#if !CUT_MAX\n", "#endif\n"),
            ("    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));\n"
             "    if (lane == 0) wmax[(t & 1) * 32 + warp] = mx;\n",
             "#if !CUT_MAX\n", "#endif\n")],
        # no decision stores (the ballot with them)
        "CUT_DEC": [
            ("      const unsigned word = __ballot_sync(kAll, ch);  // states st - lane ..\n"
             "      if (lane == 0) dec[(long long)t * NW + e * NWt + warp] = word;\n",
             "#if !CUT_DEC\n", "#endif\n")],
        # no traceback: thread 0 skips its loop over the steps
        "CUT_TB": [
            ("  if (tid == 0)\n    for (int t = T - 1; t >= 0; --t) {",
             "#if CUT_TB\n  if (false)\n#endif\n", "")],
        "THREADS": [("constexpr int kBlockThreads = 1024;",
                     "#if 0\n", "#endif\nconstexpr int kBlockThreads = THREADS;\n")],
    }, (("full", {}), ("no max", {"CUT_MAX": 1}),
        ("no decision stores", {"CUT_DEC": 1}),
        ("no traceback", {"CUT_TB": 1}),
        ("512 threads", {"THREADS": 512}),
        ("256 threads", {"THREADS": 256}))),
    "acs": ({
        # no max: g stays 0, no redux, no table of warp maxima
        "CUT_MAX": [
            ("    if (t > 0 && !solo) g = step_max(t - 1);\n", "#if !CUT_MAX\n",
             "#endif\n"),
            ("    const int key = __reduce_max_sync(kAll, fkey(mx));\n",
             "#if CUT_MAX\n    const int key = 0;\n#else\n", "#endif\n"),
            ("      g = unkey(key);\n", "#if !CUT_MAX\n", "#endif\n")],
        # no decision stores
        "CUT_DEC": [
            ("    unsigned* drow = dec + (long long)t * NW;\n"
             "    if constexpr (E >= 8) {\n", "#if !CUT_DEC\n", ""),
            ("      if (lane < E && lane * 32 < Sb) drow[(r * Sb >> 5) + (tid >> 5) * E + lane] = wd;\n"
             "    }\n", "", "#endif\n")],
        # no traceback
        "CUT_TB": [
            ("  if (warp == 0) {\n    if (out)\n      traceback_warp<false>(",
             "#if !CUT_TB\n", ""),
            ("      traceback_warp<true>(dec, T, S, state, out, bf, nbits, ring);\n  }\n",
             "", "#endif\n")],
        # no branch-metric table a step (step 0's stays)
        "CUT_TAB": [
            ("      fill_tab(t + 1, rn);\n", "#if !CUT_TAB\n", "#endif\n")],
    }, (("full", {}), ("no max", {"CUT_MAX": 1}),
        ("no decision stores", {"CUT_DEC": 1}),
        ("no traceback", {"CUT_TB": 1}),
        ("no table a step", {"CUT_TAB": 1}))),
}


def _s3_cut_libs(out: Path) -> tuple:
    """``csrc/viterbi.cu`` of the package on the path with the cuts of its
    form in ``_S3_FORMS`` ("acs" where the tree has the block and cluster
    instance, else "block-a-frame") behind their macros, built alone once
    a variant (every nvcc started together) under ``out``; the form's name
    and the variants' libraries."""
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "viterbi.cu").read_text()
    form = "acs" if "viterbi_acs_kernel" in text else "block-a-frame"
    cuts, variants = _S3_FORMS[form]
    anchors = [a for cs in cuts.values() for a, _, _ in cs]
    if any(text.count(a) != 1 for a in anchors):
        raise SystemExit(f"viterbi.cu: the {form} kernel's cut anchors are "
                         f"not there once")
    for cs in cuts.values():
        for a, pre, post in cs:
            text = text.replace(a, pre + a + post)
    src = out / "viterbi.cu"
    src.write_text("#ifndef THREADS\n#define THREADS 1024\n#endif\n"
                   + "".join(f"#ifndef {m}\n#define {m} 0\n#endif\n"
                             for m in cuts if m != "THREADS") + text)
    nvcc = _build._find_nvcc()
    jobs = {}
    for name, macros in variants:
        tag = re.sub(r"\W+", "_", name)
        obj, so = out / f"s3_{tag}.o", out / f"libs3_{tag}.so"
        flags = [f"-D{k}={v}" for k, v in macros.items()]
        jobs[name] = (obj, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (obj, so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc viterbi.cu ({name}):\n{log}")
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o", str(so),
                        str(obj)], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("viterbi_launch", "viterbi_acs_launch"):
            if hasattr(lib, fn) and fn in _build.SIGNATURES:
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return form, libs


# S4's and S5's chained scan taken apart (``scansplit``): cumulative cuts
# of csrc/scan.cu, each (text, replacement); a cut's outputs are not the
# kernel's, only its time means anything
_SCAN_CUTS = (
    ("no look-back", [
        ("    wait_flags(want, lane < grp ? gflags + lane * cs + c : nullptr,\n"
         "               j0 < tile ? flags + j0 * cs + c : nullptr,\n"
         "               j1 < tile ? flags + j1 * cs + c : nullptr);\n"
         "    for (int g = lane; g < grp; g += 32) {",
         "    for (int g = lane; g < 0; g += 32) {"),
        ("      if (j < tile) {\n        float w[P];",
         "      if (j < 0) {\n        float w[P];"),
        ("    if (tile % kGroup == kGroup - 1 && tile < ntiles - 1) {\n"
         "      // the group's aggregate",
         "    if (false) {\n      // the group's aggregate"),
        ("    wait_flags(want, g1 > g0 ? gflags + g0 : nullptr,\n"
         "               j0 < tile ? flags + j0 : nullptr,\n"
         "               j1 < tile ? flags + j1 : nullptr);\n", ""),
        ("    for (int g = g0; g < g1; ++g) {", "    for (int g = g0; g < g0; ++g) {"),
        ("      if (j < tile) {\n        const float2 m",
         "      if (j < 0) {\n        const float2 m"),
        ("    if (tile % kGroup == kGroup - 1 && tile < ntiles - 1) {\n"
         "      // j1 of lane 31", "    if (false) {\n      // j1 of lane 31"),
    ]),
    ("no publication", [
        ("      if (tile < ntiles - 1) {\n#pragma unroll\n        for (int r = 0;",
         "      if (false) {\n#pragma unroll\n        for (int r = 0;"),
        ("      if (tile < ntiles - 1) {\n        __stcg(vals + tile,",
         "      if (false) {\n        __stcg(vals + tile,"),
    ]),
    ("no ticket", [
        ("  const int me = take_ticket(ticket, &want);",
         "  const int me = blockIdx.x;\n  want = 1u;"),
        ("  const int tile = take_ticket(ticket, &want);",
         "  const int tile = blockIdx.x;\n  want = 1u;"),
    ]),
)


def _scan_cut_libs(out: Path) -> dict:
    """``csrc/scan.cu`` of the package on the path whole and with the cuts
    of ``_SCAN_CUTS`` applied in turn, each built alone under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "scan.cu").read_text()
    texts = {"whole": text}
    for name, cuts in _SCAN_CUTS:
        for a, b in cuts:
            if text.count(a) != 1:
                raise SystemExit(f"scan.cu: a cut anchor of {name!r} is not "
                                 f"there once: {a[:60]!r}")
            text = text.replace(a, b)
        texts[name] = text
    libs = {}
    for i, (name, t) in enumerate(texts.items()):
        src = out / f"scan_{i}.cu"
        src.write_text(t)
        so = out / f"libscan_{i}.so"
        _build._compile([src], so)
        lib = ctypes.CDLL(str(so))
        for fn in ("iir_scan_launch", "agc_scan_launch"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def scansplit() -> list[dict]:
    """S4 at 104448 rf32 samples (config #1's de-emphasis taps) and S5 at
    2^20 cf32, whole and cut (``_SCAN_CUTS``), by CUDA-graph replay, the
    variants forward then backward, beside ``Tensor.copy_`` of the same
    bytes; each record the best."""
    from newsched_tpu_torch.blocks import analog
    from newsched_tpu_torch.ops import agc, iir
    from newsched_tpu_torch.ops.cuda import scan as kscan

    libs = _scan_cut_libs(Path(_build.BUILD_DIR).parent / "split_scan")
    ff, fb = iir.lfilter_taps(*analog._emphasis_taps(50_000.0, 75e-6, None,
                                                     True))
    n4, n5 = 104448, 1 << 20
    xa = torch.randn(n4, device="cuda")
    xq = torch.randn(n5, dtype=torch.complex64, device="cuda")
    s4 = iir.iir_init_state(len(ff), len(fb), "cuda")
    s5 = agc.agc_init_state(1.0, "cuda")
    rate = torch.tensor(1e-2, device="cuda")
    ref = torch.tensor(1.0, device="cuda")
    full = _build.lib
    ms: dict = {}
    try:
        order = list(libs)
        for variant in order + order[::-1]:
            _build.lib = (lambda lib=libs[variant]: lib)
            c = iir.iir_consts(ff, fb, n4, "cuda")
            ws = kscan.agc_workspace(n5, "cuda")
            ms.setdefault(("S4", variant), []).append(graph_ms(
                lambda: iir.iir_filter(ff, fb, s4, xa, consts=c)))
            ms.setdefault(("S5", variant), []).append(graph_ms(
                lambda: agc.agc(s5, xq, rate, ref, workspace=ws)))
    finally:
        _build.lib = full
    ya, yq = torch.empty_like(xa), torch.empty_like(xq)
    ms[("S4", "copy")] = [graph_ms(lambda: ya.copy_(xa))]
    ms[("S5", "copy")] = [graph_ms(lambda: yq.copy_(xq))]
    return [{"scan_split": k, "variant": v, "ms": min(t), "ms_all": t}
            for (k, v), t in ms.items()]


def _s3_llrs(polys, K: int, frames: int, nbits: int = 512, seed: int = 0):
    """Noisy soft LLRs (sigma 0.8) of seeded frames of ``polys``, on the
    card: (frames, nbits + K - 1, n)."""
    rng = np.random.default_rng(seed + K)
    bits = rng.integers(0, 2, (frames, nbits))
    coded = fec.conv_encode(torch.from_numpy(bits), polys, K).numpy()
    rx = 2.0 * coded - 1.0 + rng.normal(0, 0.8, coded.shape)
    return torch.from_numpy(rx.astype(np.float32)).cuda().reshape(
        frames, nbits + K - 1, len(polys))


def s3split() -> list[dict]:
    """S3's kernel for the block routes taken apart at those routes
    (``S3_SPLIT_ROUTES``: K = 12 and rate 1/5 at 256 frames, K = 16 at 16
    frames, 512 bits a frame), each variant of its form in ``_S3_FORMS`` a
    cut copy of the tree's ``csrc/viterbi.cu`` built alone under
    ``build/split_s3/``: the block-a-frame kernel whole, without the step's
    max, the decision stores or the traceback, and at 512 and 256 threads a
    frame (1024 whole); the block and cluster instance whole, without the
    max, the decision stores, the traceback or a step's table of branch
    metrics. By CUDA-graph replay, the variants forward then backward; each
    record the best, and ns a step. Only the times mean anything: a cut's
    bits are not the decoder's."""
    form, libs = _s3_cut_libs(Path(_build.BUILD_DIR).parent / "split_s3")
    full = _build.lib
    ms: dict = {}
    try:
        for name, polys, K, F in S3_SPLIT_ROUTES:
            tabs = fec.viterbi_tables(polys, K, "cuda")
            llr = _s3_llrs(polys, K, F)
            order = list(libs)
            for variant in order + order[::-1]:
                _build.lib = (lambda lib=libs[variant]: lib)
                ms.setdefault((name, variant), []).append(graph_ms(
                    lambda: kfec.viterbi_frames(llr, tabs, K, True)))
    finally:
        _build.lib = full
    steps = {name: 512 + K - 1 for name, _, K, _ in S3_SPLIT_ROUTES}
    return [{"s3_split": name, "form": form, "variant": v, "ms": min(t),
             "ms_all": t, "ns_a_step": 1e6 * min(t) / steps[name]}
            for (name, v), t in ms.items()]


# codes past the block and cluster instance (K <= 6 past rate 1/4, rates
# past 1/8), which take the serial instance: rate 1/5 at K = 5 and rate
# 1/9 at K = 7 (the rate-1/9 generators at K = 12 end in a 12-bit one)
S3_SERIAL_N5 = (0o25, 0o33, 0o37, 0o35, 0o27)
S3_SERIAL_N9 = (0o171, 0o133, 0o165, 0o117, 0o127, 0o155, 0o135, 0o147,
                0o163)
# S3's routes timed by ``s3`` (chip_smoke.py S3_ROUTES and phase 51's
# FEC link): name, code, K, bits a frame, frames
S3_TIME_ROUTES = (
    ("K=7", (0o171, 0o133), 7, 512, 1024),
    ("K=11", (0o2565, 0o3753), 11, 512, 1024),
    ("global", (0o171, 0o133), 7, 16384, 16),
    ("n=5", (0o171, 0o133, 0o165, 0o117, 0o127), 7, 512, 256),
    ("K=12", (0o4037, 0o5741), 12, 512, 256),
    ("K=15", (0o46321, 0o51271, 0o63667, 0o70535), 15, 512, 32),
    ("K=16", (0o152711, 0o126723), 16, 512, 16),
    ("K=17", (0o251343, 0o367375), 17, 512, 4),
    ("K=18", (0o561753, 0o703515), 18, 512, 2),
    ("serial K=5", S3_SERIAL_N5, 5, 512, 256),
    ("serial n=9", S3_SERIAL_N9, 7, 512, 256),
    ("serial K=12", S3_SERIAL_N9[:8] + (0o6153,), 12, 512, 64),
)
# other geometries (states a thread E, blocks a frame C) of the block and
# cluster instance, timed by ``s3 --geometries`` where the tree has them
S3_GEOMETRIES = {"K=11": ((8, 2),),
                 "K=12": ((8, 2), (16, 1)),
                 "K=15": ((8, 4), (16, 4), (16, 8)),
                 "K=16": ((16, 8), (32, 8))}


def s3(argv) -> list[dict]:
    """S3 at ``S3_TIME_ROUTES``' shapes under the package on the path, its
    ``csrc/viterbi.cu`` built alone: each route's bits against the plain
    version on the card, the instance that ran (its counts), its time by
    CUDA-graph replay and ns a step; with ``--geometries`` the block and
    cluster instance at ``S3_GEOMETRIES`` too, launched directly (a tree
    with ``acs_layout``). Run under two trees in turns to compare them."""
    lib = _alone_lib("viterbi")
    full = _build.lib
    _build.lib = lambda: lib
    vf = kfec.viterbi_frames
    counts = [c for c in ("launches", "block_launches", "cluster_launches",
                          "serial_launches", "global_launches",
                          "metric_launches") if hasattr(vf, c)]
    recs = []
    try:
        for name, polys, K, nbits, F in S3_TIME_ROUTES:
            tabs = fec.viterbi_tables(polys, K, "cuda")
            llr = _s3_llrs(polys, K, F, nbits)
            runs = [(None, lambda: vf(llr, tabs, K, True))]
            if "--geometries" in argv and hasattr(kfec, "acs_layout"):
                for E, C in S3_GEOMETRIES.get(name, ()):
                    try:
                        lay = kfec.acs_layout(nbits + K - 1, len(polys), K,
                                              E, C, F)
                    except ValueError:
                        continue
                    runs.append(((E, C), lambda lay=lay: _acs_at(
                        lib, llr, tabs, K, lay, nbits)))
            ref = kfec.viterbi_frames_plain(llr, tabs, True, nbits)
            for geom, call in runs:
                before = {c: getattr(vf, c) for c in counts}
                equal = torch.equal(call(), ref)
                ran = {c: getattr(vf, c) - before[c] for c in counts
                       if getattr(vf, c) != before[c]}
                ms = graph_ms(call)
                recs.append({"s3": name, "K": K, "n": len(polys),
                             "frames": F, "bits": nbits,
                             "geometry": geom, "counts": ran,
                             "bit_equal": equal, "ms": ms,
                             "ns_a_step": 1e6 * ms / (nbits + K - 1)})
                print(json.dumps(recs[-1]), flush=True)
    finally:
        _build.lib = full
    return []


def _acs_at(lib, llr, tabs, K: int, lay, nbits: int) -> torch.Tensor:
    """The block and cluster instance launched at the geometry ``lay``
    (``kfec.acs_layout``: E, C, memory) on terminated frames, as
    ``viterbi_frames`` launches it at its own: (F, nbits) int32 bits."""
    F, T, n = llr.shape
    S = 1 << (K - 1)
    bits = torch.empty((F, nbits), dtype=torch.int32, device=llr.device)
    dec = (torch.empty(F * T * max(1, S // 32), dtype=torch.int32,
                       device=llr.device) if lay.memory == "global" else None)
    err = lib.viterbi_acs_launch(
        llr.data_ptr(), bits.data_ptr(), tabs.psym.data_ptr(),
        None if dec is None else dec.data_ptr(), F, T, n, S, lay.E, lay.C, 1,
        nbits, int(lay.memory == "global"),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "viterbi_acs_launch")
    return bits


def _alone_lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` of the package on the path built alone (with the
    headers it includes) under ``build/alone/``, named by a hash of the
    sources; the launchers it defines given their argument types."""
    import hashlib

    src = _build.CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(_build.CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    out = Path(_build.BUILD_DIR).parent / "alone"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        log = _build._compile([src], so)
        regs = re.findall(r"Function properties for \S*?(\w+?)\n"
                          r"\s*(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores[\s\S]*?Used (\d+) registers", log)
        print(json.dumps({"build": str(so), "stack, spills, registers":
                          [r for r in regs if "pipe" in r[0]
                           or "viterbi" in r[0]]}), flush=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


# K3p's roles taken apart (``k3p --split``): cut copies of csrc/fm_chain.cu
# in which the fold group or the demod group does none of its work, only
# its waits and hand-overs: (anchor, text before it, text after it)
_K3P_CUTS = {
    "CUT_F": [
        ("        if (L == kFoldL)\n          fold_pass_to<kFoldL>(",
         "#if CUT_F\n        release();\n        continue;\n#endif\n", ""),
        ("      for (int b = 4 * (ft >> 5); b < nr; b += kPipeFold / 8) {\n"
         "        const int r = b + ((ft >> 3) & 3);\n"
         "        planes_fft::fft_row<1>(slot + r * W, r, ft & 7, tw, p.tw);\n"
         "      }\n", "#if !CUT_F\n", "#endif\n")],
    "CUT_D": [
        ("      for (int idx = dt; idx < (nr - j0) * M; idx += kPipeDemod) {\n"
         "        const int jj = j0 + idx / M, m = idx % M, t = u0 + jj;\n",
         "#if !CUT_D\n", ""),
        ("        ring[rr * M + m] = val;\n      }\n", "", "#endif\n"),
        ("        for (int idx = dt; idx < n_o * M; idx += kPipeDemod) {\n"
         "          const int o = idx / M, m = idx % M;\n", "#if !CUT_D\n", ""),
        ("          p.aud[((long long)u0 / p.decim + o) * M + m] = acc;\n"
         "        }\n", "", "#endif\n")],
}
_K3P_VARIANTS = (("whole", {}), ("no fold group work", {"CUT_F": 1}),
                 ("no demod group work", {"CUT_D": 1}),
                 ("neither", {"CUT_F": 1, "CUT_D": 1}))


def _k3p_cut_libs(out: Path) -> dict:
    """``csrc/fm_chain.cu`` with ``_K3P_CUTS`` behind their macros, built
    alone once a variant of ``_K3P_VARIANTS`` (every nvcc at once) under
    ``out``: the variants' libraries."""
    out.mkdir(parents=True, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        (out / hdr.name).write_text(hdr.read_text())
    text = (_build.CSRC / "fm_chain.cu").read_text()
    for cuts in _K3P_CUTS.values():
        for a, pre, post in cuts:
            if text.count(a) != 1:
                raise SystemExit("fm_chain.cu: a K3p cut's anchor is not "
                                 "there once")
            text = text.replace(a, pre + a + post)
    src = out / "fm_chain.cu"
    src.write_text("".join(f"#ifndef {m}\n#define {m} 0\n#endif\n"
                           for m in _K3P_CUTS) + text)
    nvcc = _build._find_nvcc()
    jobs = {}
    for name, macros in _K3P_VARIANTS:
        tag = re.sub(r"\W+", "_", name)
        obj, so = out / f"k3p_{tag}.o", out / f"libk3p_{tag}.so"
        jobs[name] = (obj, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *[f"-D{k}={v}" for k, v in
                                         macros.items()],
             "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (obj, so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc fm_chain.cu ({name}):\n{log}")
        subprocess.run([nvcc, *_build.NVCC_FLAGS[:2], "-shared", "-o",
                        str(so), str(obj)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.fm_chain_pipe_launch.argtypes = _build.SIGNATURES[
            "fm_chain_pipe_launch"]
        lib.fm_chain_pipe_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


K3P_TILES = ((64, (1, 2, 4)), (128, (1, 2)))  # tile, tiles a block checked


def k3p(argv=()) -> list[dict]:
    """K3p (``fm_chain_step_planes(pipelined=True)``) against K3 under the
    package on the path, ``csrc/fm_chain.cu`` built alone: two carried
    batches of the flagship's 32768 x 128 rows (K4's noise) at tiles 64
    and 128, at its default tiles a block and at ``K3P_TILES``' (bit-equal
    to K3's audio, prev and tail), and with warm = 512 on the second of 4
    shards of a batch (bit-equal); then, in turns by CUDA-graph replay, K3
    (tile 128) and K3p at tiles 64 and 128 (their default tiles a block).
    With ``--split`` K3p's roles taken apart too (``_K3P_VARIANTS``: cut
    copies built under ``build/split_k3p/``), timed in the same turns."""
    M, L, A, D, n = 64, 16, 65, 8, 32768
    taps = firdes.prototype_channelizer_taps(M, L)
    at = firdes.low_pass(1.0, 1.0, 0.4 / D, 0.1 / D, ntaps=A)
    c = np.ascontiguousarray(pfb.pfb_arm_taps(taps, M)[::-1, ::-1].T)
    consts = fm_chain.fm_chain_consts(c, at, "cuda")
    z = dict(dtype=torch.float32, device="cuda")
    amp = torch.tensor(0.5, **z)
    rows = torch.cat([_k4(torch.tensor(g, dtype=torch.int64, device="cuda"),
                          amp) for g in (5, 6)])
    H8 = fm_chain._round8(L - 1)
    lib = _alone_lib("fm_chain")
    full = _build.lib
    _build.lib = lambda: lib
    step = fm_chain.fm_chain_step_planes

    def batches(fn, **kw):
        halo = torch.zeros(H8, 2 * M, **z)
        prev, tail = torch.zeros(1, 2 * M, **z), torch.zeros(A - 1, 2 * M, **z)
        outs = []
        for b in range(2):
            vb = rows[b * n:(b + 1) * n]
            aud, prev, tail = fn(vb, halo, prev, tail, consts, D, 0.5, **kw)
            outs += [aud, prev, tail]
            halo = vb[-H8:].contiguous()
        return outs

    recs = []
    try:
        k3 = batches(step)
        before = step.pipe_launches
        for tile, gs in K3P_TILES:
            for G in (None, *gs):
                got = batches(fm_chain._pipe, tile=tile, tiles_per_block=G)
                recs.append({"k3p_check": "2 batches", "tile": tile, "G": G,
                             "bit_equal": all(torch.equal(a, b)
                                              for a, b in zip(got, k3))})
        nl, warm = n // 4, 512
        hr = warm + H8
        args = (rows[nl:2 * nl], rows[nl - hr:nl], torch.zeros(1, 2 * M, **z),
                torch.zeros(A - 1, 2 * M, **z), consts, D, 0.5)
        a = step(*args, warm=warm)
        b = step(*args, warm=warm, pipelined=True)
        recs.append({"k3p_check": "warm 512, shard 1 of 4",
                     "bit_equal": all(torch.equal(x, y) for x, y in zip(a, b))})
        recs.append({"k3p_launches": step.pipe_launches - before})
        st = (rows[:H8].clone(), torch.zeros(1, 2 * M, **z),
              torch.zeros(A - 1, 2 * M, **z))
        vb = rows[:n]
        calls = {"K3": lambda: step(vb, *st, consts, D, 0.5),
                 "K3p tile 64": lambda: fm_chain._pipe(vb, *st, consts, D,
                                                        0.5, 64, None),
                 "K3p tile 128": lambda: fm_chain._pipe(vb, *st, consts, D,
                                                         0.5, 128, None)}
        cut = (_k3p_cut_libs(Path(_build.BUILD_DIR).parent / "split_k3p")
               if "--split" in argv else {})
        runs = [(k, fn, lib) for k, fn in calls.items()] + [
            (f"K3p tile 64, {v}", calls["K3p tile 64"], cl)
            for v, cl in cut.items()]
        ms: dict = {}
        for name, fn, cl in runs + runs[::-1]:
            _build.lib = lambda cl=cl: cl
            ms.setdefault(name, []).append(graph_ms(fn))
        recs += [{"k3p_time": k, "ms": min(v), "ms_all": v}
                 for k, v in ms.items()]
    finally:
        _build.lib = full
    return recs


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
    from newsched_tpu_torch.parallel import make_mesh

    for kind, nd in (("fused", 1), ("staged", 1), ("live", 1), ("live", 4)):
        fg, blks = _fm_graph(kind, 2)
        fg.run(device="cuda", mesh=make_mesh(nd) if nd > 1 else None)
        key = f"graph/{kind}" + (f"/{nd} shards" if nd > 1 else "")
        res[key] = torch.from_numpy(np.asarray(blks["sink"].data()))
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
    c64 = np.ascontiguousarray(pfb.pfb_arm_taps(
        firdes.prototype_channelizer_taps(64, 16), 64)[::-1, ::-1].T)
    cc64 = fm_chain.fm_chain_consts(c64, firdes.low_pass(
        1.0, 1.0, 0.05, 0.0125, ntaps=65), "cuda")
    r64 = _k4(g0, amp)  # the flagship's batch, 32768 rows of M = 64
    st64 = (torch.zeros(16, 128, **z), torch.zeros(1, 128, **z),
            torch.zeros(64, 128, **z))
    calls["K3 M=64"] = lambda: fm_chain.fm_chain_step_planes(r64, *st64, cc64,
                                                            8, 0.5)
    calls["K5 M=64"] = lambda: fm_chain.fm_chain_gen_step(g0, amp, *st64,
                                                         cc64, 8, 0.5, 32768)
    for nd in (4, 8):
        calls[f"K6 M=64 {nd} shards"] = (
            lambda nd=nd: fm_chain.fm_chain_gen_warm_step(
                g0, amp, cc64, 8, 0.5, 32768 // nd, warm=512, nd=nd))
    for M in (512, 1024):  # K4 at the chains' widths, beside K5 and K6
        calls[f"K4 amp 16384x{2 * M}"] = (
            lambda M=M: _k4(g0, amp, n_rows=16384, width=2 * M))
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
    for tile in (64, 256):
        carry, prev, tail = torch.zeros(16, 2 * M, **z), zp, zt
        for b in range(2):
            grp = torch.tensor(b * n // 64, dtype=torch.int64, device="cuda")
            aud, prev, tail, carry = fm_chain.fm_chain_gen_step(
                grp, amp, carry, prev, tail, consts, D, 0.5, n, tile=tile)
            res[f"K5/t{tile}/{b}/aud"] = aud.cpu()
            res[f"K5/t{tile}/{b}/carry"] = carry.cpu()
    grp = torch.tensor(0, dtype=torch.int64, device="cuda")
    res["K6"] = fm_chain.fm_chain_gen_warm_step(
        grp, amp, consts, D, 0.5, 8192, warm=512, goff=3 * 8192 // 64).cpu()
    for nd in (4, 8):
        for base in (0, (1 << 32) - 2):
            grp = torch.tensor(base, dtype=torch.int64, device="cuda")
            res[f"K6/{base}/nd{nd}"] = fm_chain.fm_chain_gen_warm_step(
                grp, amp, consts, D, 0.5, n // nd, warm=512, nd=nd).cpu()
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
    if M == 512:  # K3 at warm > 0 over the 4 shards of a batch, one launch
        zp, zt = torch.zeros(1, W, **z), torch.zeros(A - 1, W, **z)
        res[f"K3 M={M}/warm/nd4"] = fm_chain.fm_chain_step_planes(
            rows[n:].contiguous(), rows[n - 512 - 16:n].contiguous(), zp, zt,
            consts, D, 0.5, warm=512, nd=4)[0].cpu()
    return res


def _wide_chain_outputs() -> dict:
    """K3 (two carried batches), K3ag (ag = 2), K5 and K6 (a shard of 4096
    rows at shard 3) at M = 128 .. 448, 512 and 1024 on seeded rows of
    16384 (a width the tree refuses skipped), K3 at warm > 0 over the 4
    shards of a batch at M = 512, and S3 on
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
            sharded_steps() if argv[:1] == ["sharded"] else
            split() if argv[:1] == ["split"] else
            wide(argv[1:]) if argv[:1] == ["wide"] else
            s3split() if argv[:1] == ["s3split"] else
            scansplit() if argv[:1] == ["scansplit"] else
            s3(argv[1:]) if argv[:1] == ["s3"] else
            k3p(argv[1:]) if argv[:1] == ["k3p"] else outputs(argv[1:]))
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
