"""Device timing shared by the on-GPU scripts."""

from __future__ import annotations

import statistics

import torch

H100_BYTES_PER_S = 3.35e12         # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
_FLUSH_BYTES = 128 * 2 ** 20       # > the H100's 50 MB L2, read in full


def bound_ms(n_bytes, n_ops):
    """The least time one H100 could take: (ms, "bytes" or "operations"),
    the larger of the bytes over the memory rate and the f32 operations
    over the f32 rate."""
    t_b = n_bytes / H100_BYTES_PER_S
    t_o = n_ops / H100_F32_FLOP_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def cuda_ms(fn, reps: int = 25, warm: int = 3, flush: bool = False) -> float:
    """Median device time (ms) of one call of ``fn``, CUDA events around
    each call. A sleep kernel holds the stream first, so the events time
    the work and not the host's enqueue (unless ``fn`` itself waits for the
    device). With ``flush``, a 128 MiB buffer is read (summed) between the
    sleep and the first event, so each timed call finds its inputs out of
    L2; reading leaves no dirty lines for the timed call to write back."""
    buf = torch.ones(_FLUSH_BYTES // 4, dtype=torch.float32,
                     device="cuda") if flush else None
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if buf is not None:
            buf.sum()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
