"""Device timing shared by the on-GPU scripts."""

from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median device time (ms) of one call of ``fn``, CUDA events around
    each call. A sleep kernel holds the stream first, so the events time
    the work and not the host's enqueue (unless ``fn`` itself waits for the
    device)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
