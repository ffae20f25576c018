"""Tracing and profiling utilities (port of
``tssplat_tpu/utils/profiling.py``).

``span`` names a stretch of the program (a layer of the train step, or a
statement where the host waits for the device) in the profiler's own
trace, only while a profiler records. ``trace_profile`` captures a
``torch.profiler`` trace (CPU and, where there is one, CUDA activity) into
``log_dir`` as a Chrome trace; the spans land in it on the same clock as
the CUDA runtime calls and the device's kernels. ``ThroughputMeter`` is
the driver's iters/s and rays/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("tssplat.<layer>"):`` records the block as a
    ``user_annotation`` range of the running profiler's trace
    (``torch.profiler.record_function``), and does nothing when no
    profiler records: one check of ``torch.autograd._profiler_enabled()``
    a span. The profiler's state reaches autograd's device threads, so a
    span in a backward (a checkpointed chunk's recompute, a custom
    Function's backward) lands in the trace too. Names start with
    ``tssplat.``; ``tssplat.sync.<site>`` marks a statement that waits for
    the device; ``tssplat.graph`` a replay of the geometry step's CUDA
    graph (``step_graph.py``: the layer spans inside it are not recorded,
    no host code runs there) and ``tssplat.graph_capture`` its capture."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace_profile(log_dir: str, enabled: bool = True):
    """Profile the block with ``torch.profiler`` (CUDA activity too where
    a card is there) and write its Chrome trace to
    ``log_dir/trace_<pid>.json`` (open it in chrome://tracing or
    Perfetto). Yields the profiler, or None when not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()      # the block's kernels in the trace
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class ThroughputMeter:
    """Sliding counters for optimization throughput.

    update(n_iters, n_rays) after each step; ``iters_per_sec`` /
    ``rays_per_sec`` read the rate since the last reset (the first update
    after construction or reset() starts the clock, so the first step's
    set-up is excluded).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = None
        self.iters = 0
        self.rays = 0

    def update(self, n_iters: int = 1, n_rays: int = 0):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            return
        self.iters += n_iters
        self.rays += n_rays
        self.t_last = now

    def _dt(self):
        if self.t0 is None or self.iters == 0:
            return None
        return max(self.t_last - self.t0, 1e-9)

    @property
    def iters_per_sec(self) -> Optional[float]:
        dt = self._dt()
        return None if dt is None else self.iters / dt

    @property
    def rays_per_sec(self) -> Optional[float]:
        dt = self._dt()
        return None if dt is None else self.rays / dt

    def summary(self) -> str:
        ips = self.iters_per_sec
        rps = self.rays_per_sec
        parts = []
        if ips is not None:
            parts.append(f"{ips:.3f} iters/s")
        if rps:
            parts.append(f"{rps / 1e6:.2f} Mrays/s")
        return ", ".join(parts) if parts else "n/a"
