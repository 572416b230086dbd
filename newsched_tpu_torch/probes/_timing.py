"""Device times of the probes' calls (CUDA events; the card is required)."""

from __future__ import annotations

import torch


def graph_ms(fn, reps: int = 10, inner: int = 10) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph
    (so the host's launch time is left out), the graph replayed under CUDA
    events; the median of ``reps`` replays, over ``inner``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(sorted(times)[len(times) // 2])
