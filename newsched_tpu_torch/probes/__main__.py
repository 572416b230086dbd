"""Run the probes on the card and print one JSON line a measurement:

    python3 -m newsched_tpu_torch.probes

The card's name and power limit come first; without a CUDA device it
exits with an error and measures nothing."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from newsched_tpu_torch.probes import run


def main() -> int:
    if not torch.cuda.is_available():
        print("newsched_tpu_torch.probes: no CUDA device; the probes measure "
              "the card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for rec in run.dma_sweep() + run.prep_times() + run.ablate_times():
        print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
