"""Run the probes on the card and print one JSON line a measurement:

    python3 -m newsched_tpu_torch.probes [dma] [prep] [ablate] [fold] [ingest]

(no group named: every group). The card's name and power limit come
first; without a CUDA device it exits with an error and measures
nothing."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from newsched_tpu_torch.probes import ingest, run


def main() -> int:
    if not torch.cuda.is_available():
        print("newsched_tpu_torch.probes: no CUDA device; the probes measure "
              "the card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    groups = {"dma": run.dma_sweep, "prep": run.prep_times,
              "ablate": run.ablate_times, "fold": run.fold_times,
              "ingest": ingest.ingest_times}
    names = sys.argv[1:] or list(groups)
    unknown = set(names) - set(groups)
    if unknown:
        print(f"newsched_tpu_torch.probes: no group {sorted(unknown)}; the "
              f"groups are {list(groups)}", file=sys.stderr)
        return 2
    print(card, flush=True)
    for name in names:
        for rec in groups[name]():
            print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
