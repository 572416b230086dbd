"""The port's one-command check, with a results file (the twin of the
reference's scripts/check.py).

    python3 -m newsched_tpu_torch.check [--out PATH] [--skip-gpu]
                                        [--tiers NAME,...] [--log-dir DIR]

Tiers, in order:
  cpu_suite    the port's tests, ``pytest tests/test_torch_*.py`` on the
               CPU (they import the JAX package as their reference);
  example:*    the seven examples, each ``main(device="cpu")``;
  mesh_gates   the sharded graphs on logical meshes of 4 and 8 CPU shards
               against their unsharded twins, bit for bit (the reference's
               multi-chip dryrun);
  chip_smoke   on a card: ``python3 chip_smoke.py``, gated on its last
               line (``"ok": true`` on a "gpu" platform);
  bench        on a card: ``python3 -m newsched_tpu_torch.bench``, gated
               on its last line (no error, the headline above FLOOR_MSPS).

``--tiers`` runs only the tiers named (``examples`` names every
example); ``--skip-gpu``, or no visible card, records the card's tiers
as ``{"ok": null, "skipped": true, "reason": ...}``, never as passed. The
results go to one JSON file (default ``build/check.json``), each tier's
whole output to ``DIR/<tier>.log`` with ``--log-dir``; the exit code is 1
if a tier that ran failed. Nothing here imports the JAX package: the
CPU suite's tests do, in their own process, and the card's machine
runs only the card's tiers (``--tiers chip_smoke,bench``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "build" / "check.json"
EXAMPLES = ("fm_receiver", "channelizer", "yaml_block", "distributed_pipeline",
            "sharded_channelizer", "live_flagship", "retune_live_receiver")
# the bench's headline floor, Msamples/s: the reference's (scripts/check.py),
# a structural regression check far below the card's step
FLOOR_MSPS = 8000.0
CPU_ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}


def run(cmd: list, timeout: float, env=None, label: str = "") -> dict:
    """``cmd`` from the repo's root: ok (exit code 0), seconds, the output's
    tail, and the whole stdout and output under ``_stdout`` and ``_out``
    (kept off the results)."""
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, env=env or os.environ,
                           capture_output=True, text=True, timeout=timeout)
        ok, stdout = p.returncode == 0, p.stdout or ""
        out = stdout + (p.stderr or "")
    except subprocess.TimeoutExpired as e:
        ok, stdout = False, ""
        out = f"TIMEOUT after {timeout}s\n" + str(e.output or "")[-2000:]
    return {"label": label or " ".join(map(str, cmd)), "ok": ok,
            "seconds": round(time.monotonic() - t0, 1), "tail": out[-1500:],
            "_stdout": stdout, "_out": out}


def last_json(stdout: str):
    """The last line of ``stdout`` as JSON, or None."""
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def pytest_counts(tail: str) -> dict:
    n = {k: re.search(rf"(\d+) {k}", tail) for k in ("passed", "failed")}
    return {k: int(m.group(1)) if m else 0 for k, m in n.items()}


def cpu_suite() -> dict:
    tests = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "tests").glob("test_torch_*.py"))
    r = run([sys.executable, "-m", "pytest", *tests, "-q"], 3600, CPU_ENV,
            "cpu suite")
    return {**r, **pytest_counts(r["tail"])}


def example(name: str) -> dict:
    return run([sys.executable, "-c",
                f"from newsched_tpu_torch.examples import {name}; "
                f"{name}.main(device='cpu')"], 900, CPU_ENV, f"example {name}")


def mesh_gates(shards=(4, 8)) -> list[str]:
    """The sharded graphs (#2 fused replay: K3 at warm > 0; #2 live: K6;
    #1 fused: K10; #1 live: K12; #0 live: K9), three batches at full
    width on logical meshes of CPU shards: each bit-equal to its
    unsharded graph. Returns a line a graph and mesh; raises on the first
    that differs."""
    import numpy as np

    from newsched_tpu_torch import models
    from newsched_tpu_torch.blocks import general
    from newsched_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(20)
    rows = (rng.standard_normal((32768, 128)) * 0.5).astype(np.float32)
    x = np.exp(2j * np.pi * 0.21 * np.arange(3 * 2088960)).astype(np.complex64)
    ch = dict(fused=True, batch_size=1 << 21, n_samples=3 * 4096,
              sink="vector")
    wb = dict(fused=True, batch_size=2088960, n_samples=3 * 2088960 // 20)
    graphs = {
        "#2 fused replay": lambda: models.fm_channelizer(
            source=general.vector_source(rows, repeat=True), **ch),
        "#2 live": lambda: models.fm_channelizer(source="live", **ch),
        "#1 fused": lambda: models.wbfm_receiver(
            source=general.vector_source(x), **wb),
        "#1 live": lambda: models.wbfm_receiver(source="live", **wb),
        "#0 live": lambda: models.fir_chain(
            n_samples=3 << 21, batch_size=1 << 21, sink="vector",
            source="live"),
    }
    lines = []
    for name, build in graphs.items():
        out = {}
        for n in (1, *shards):
            fg, blks = build()
            fg.run(device="cpu",
                   mesh=make_mesh(n, device="cpu") if n > 1 else None)
            out[n] = blks["sink"].data()
        for n in shards:
            if out[n].size == 0 or not np.array_equal(out[n], out[1]):
                raise AssertionError(f"{name} on {n} CPU shards differs "
                                     f"from its unsharded graph")
            lines.append(f"{name}: {n} shards bit-equal to unsharded "
                         f"({out[n].size} samples)")
    return lines


def mesh_tier() -> dict:
    r = run([sys.executable, "-c",
             "from newsched_tpu_torch.check import mesh_gates; "
             "print('\\n'.join(mesh_gates()))"], 1800, CPU_ENV, "mesh gates")
    return r


def chip_smoke() -> dict:
    r = run([sys.executable, "chip_smoke.py"], 1500, label="chip_smoke.py")
    line = last_json(r["_stdout"])
    r["ok"] = bool(r["ok"] and line and line.get("ok") is True
                   and line.get("device", {}).get("platform") == "gpu")
    return {**r, "result": line}


def bench() -> dict:
    r = run([sys.executable, "-m", "newsched_tpu_torch.bench"], 1500,
            label="bench")
    line = last_json(r["_stdout"])
    r["ok"] = bool(r["ok"] and line and "error" not in line
                   and line.get("device") != "cpu"
                   and line.get("value", 0) >= FLOOR_MSPS)
    return {**r, "result": line, "floor_msps": FLOOR_MSPS}


class Tier(NamedTuple):
    gpu: bool  # runs only on a card
    fn: Callable[[], dict]


TIERS: dict[str, Tier] = {
    "cpu_suite": Tier(False, cpu_suite),
    **{f"example:{e}": Tier(False, lambda e=e: example(e)) for e in EXAMPLES},
    "mesh_gates": Tier(False, mesh_tier),
    "chip_smoke": Tier(True, chip_smoke),
    "bench": Tier(True, bench),
}


def selected(names: str | None) -> list[str]:
    """The tiers ``--tiers`` names, in TIERS' order (all for None);
    "examples" names every example. Raises on an unknown name."""
    if names is None:
        return list(TIERS)
    want = {n.strip() for n in names.split(",") if n.strip()}
    unknown = want - set(TIERS) - {"examples"}
    if unknown:
        raise SystemExit(f"unknown tiers {sorted(unknown)}; the tiers: "
                         f"{', '.join(TIERS)}, examples")
    return [t for t in TIERS
            if t in want or ("examples" in want and t.startswith("example:"))]


def gpu_visible() -> bool:
    r = run([sys.executable, "-c",
             "import sys, torch; sys.exit(0 if torch.cuda.is_available() "
             "else 1)"], 120, label="card probe")
    return r["ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="results JSON (default build/check.json)")
    ap.add_argument("--skip-gpu", action="store_true",
                    help="record the card's tiers as skipped")
    ap.add_argument("--tiers", default=None,
                    help="comma-separated tiers to run (default: all)")
    ap.add_argument("--log-dir", default=None,
                    help="write each tier's whole output to DIR/<tier>.log")
    args = ap.parse_args(argv)
    names = selected(args.tiers)
    skip = None
    if any(TIERS[t].gpu for t in names):
        if args.skip_gpu:
            skip = "--skip-gpu"
        elif not gpu_visible():
            skip = "no CUDA device visible"
    results = {"date": datetime.datetime.now().isoformat(timespec="seconds"),
               "tiers": {}}
    failed = []
    for name in names:
        tier = TIERS[name]
        if tier.gpu and skip:
            results["tiers"][name] = {"ok": None, "skipped": True,
                                      "reason": skip}
            print(f"[skipped] {name} ({skip})", flush=True)
            continue
        res = tier.fn()
        res.pop("_stdout", None)
        out = res.pop("_out", None)
        if args.log_dir and out is not None:
            log = Path(args.log_dir) / f"{name.replace(':', '_')}.log"
            log.parent.mkdir(parents=True, exist_ok=True)
            log.write_text(out)
            res["log"] = str(log)
        results["tiers"][name] = res
        print(f"[{'ok' if res['ok'] else 'FAILED'}] {name} "
              f"({res.get('seconds', 0)}s)", flush=True)
        if not res["ok"]:
            failed.append(name)
            print(res.get("tail", "")[-1200:], flush=True)
    results["ok"] = not failed
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"results -> {out}", flush=True)
    if failed:
        print("CHECK FAILED: " + ", ".join(failed), flush=True)
        return 1
    print("CHECK OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
