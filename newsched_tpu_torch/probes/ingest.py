"""Host ingest on the card (reference: bench/bm_ingest.py): how fast a cf32
file reaches the device through the port's file_source path, against the
target of config #2's input at 100 Msamples/s of cf32, 800 MB/s.

The path: file --(the native pump thread)--> double-mapped ring
--(read_exact)--> a host batch --(the runner's ``_Staging``: one of two
pinned buffers, ``non_blocking`` copy behind an event)--> the card, where a
checksum of every batch forces the copy. Three stages, each timed on the
host's clock over the whole file, twice, the slower pass reported (as the
reference reports), one record each:

- ``ring``: the ring alone, into one host batch;
- ``staging``: and on into one of two pinned buffers, in turn;
- ``device``: and on to the card, with the checksum there.

The file is ``FILE_MB`` MB of seeded random cf32, read once before the
stages so the page cache is warm (the stages measure the framework's path,
not the disk); the reference writes one 4 MB chunk repeated, whose bytes
differ from these but not in size. Run on the card:
``python3 -m newsched_tpu_torch.probes ingest``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

FILE_MB = 256
BATCH = 1 << 21            # cf32 items a batch (16.8 MB), bm_ingest.py's
TARGET_MBPS = 800.0        # 100 Msamples/s of cf32
RING_BYTES = 1 << 26
STAGES = ("ring", "staging", "device")
DATA_DIR = Path(__file__).resolve().parents[2] / "build" / "ingest"


def cf32_file(n_items: int, seed: int = 0, path: str | None = None) -> str:
    """A file of ``n_items`` seeded random cf32 samples (standard normal
    halves x 0.5), written in 1M-item chunks under build/ingest/ unless a
    path is given; kept if it already holds them. Returns its path."""
    if path is None:
        DATA_DIR.mkdir(parents=True, exist_ok=True)
        path = str(DATA_DIR / f"cf32_{n_items}_{seed}.bin")
    if os.path.exists(path) and os.path.getsize(path) == 8 * n_items:
        return path
    rng = np.random.default_rng(seed)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        for start in range(0, n_items, 1 << 20):
            k = min(1 << 20, n_items - start)
            x = rng.standard_normal((k, 2), dtype=np.float32) * np.float32(0.5)
            fh.write(x.tobytes())
    os.replace(tmp, path)
    return path


def cf32_items(path: str, start: int, n: int) -> np.ndarray:
    """Items [start, start + n) of a cf32 file (what a memory-fed graph is
    given to hold a file-fed one against)."""
    return np.fromfile(path, dtype=np.complex64, count=n, offset=8 * start)


def warm(path: str) -> None:
    """Read the file once, into the page cache."""
    with open(path, "rb") as fh:
        while fh.read(1 << 24):
            pass


def ingest_seconds(path: str, stage: str, device, batch: int = BATCH) -> dict:
    """One pass of ``stage`` over the whole file: its seconds, the bytes
    the ring delivered, and (stage "device") the checksum computed on
    ``device``."""
    from newsched_tpu_torch.io import VmcircRing
    from newsched_tpu_torch.runtime.runner import _Staging

    device = torch.device(device)
    n_items = os.path.getsize(path) // 8
    ring = VmcircRing(RING_BYTES)
    host = np.empty(batch, np.complex64)
    pinned = [torch.empty(batch, dtype=torch.complex64,
                          pin_memory=device.type == "cuda") for _ in range(2)]
    stage_to = _Staging(device)
    acc = torch.zeros((), dtype=torch.float64, device=device)
    try:
        t0 = time.perf_counter()
        ring.start_file_pump(path)
        done = i = 0
        while done < n_items:
            take = min(batch, n_items - done)
            ring.read_exact(host[:take])
            done += take
            if stage == "staging":
                pinned[i % 2][:take].copy_(torch.from_numpy(host[:take]))
            elif stage == "device":
                dev = stage_to(("ingest",), host[:take])
                acc += torch.view_as_real(dev).sum(dtype=torch.float64)
            i += 1
        checksum = float(acc.item())  # waits for the last copy and sum
        seconds = time.perf_counter() - t0
        reads = ring.reads
    finally:
        ring.close()
    return {"seconds": seconds, "ring_bytes": reads, "checksum": checksum,
            "n_items": n_items}


def ingest_stages(path: str, device, runs: int = 2,
                  batch: int = BATCH) -> list[dict]:
    """The three stages over ``path``, ``runs`` passes each in batches of
    ``batch`` items; a record a stage with the slower pass's rate, the
    ring's bytes, and the device stage's checksum beside the host's."""
    warm(path)
    nbytes = os.path.getsize(path)
    want = float(np.fromfile(path, np.float32).astype(np.float64).sum())
    recs = []
    for stage in STAGES:
        passes = [ingest_seconds(path, stage, device, batch)
                  for _ in range(runs)]
        slow = max(p["seconds"] for p in passes)
        rec = {"probe": f"ingest_{stage}", "MBps": nbytes / slow / 1e6,
               "Msps_cf32": nbytes / slow / 8e6,
               "runs_MBps": [nbytes / p["seconds"] / 1e6 for p in passes],
               "target_MBps": TARGET_MBPS, "file_MB": nbytes / 2 ** 20,
               "batch": batch, "ring_bytes": passes[-1]["ring_bytes"],
               "device": str(device)}
        if stage == "device":
            rec["checksum"] = passes[-1]["checksum"]
            rec["checksum_host"] = want
        recs.append(rec)
    return recs


def ingest_times() -> list[dict]:
    """The probe group: the stages over a ``FILE_MB`` MB file on the card."""
    path = cf32_file(FILE_MB * 2 ** 20 // 8)
    return ingest_stages(path, "cuda")
