"""Tracing and profiling utilities (port of
``tssplat_tpu/utils/profiling.py``).

The reference ships a timing helper that was never wired into its trainer
(reference utils/config.py:49-95, PrintExecTime and a timestamp stack);
``PrintExecTime`` keeps its shape. ``trace_profile`` captures a
``torch.profiler`` trace (CPU and, where there is one, CUDA activity) into
``log_dir`` as a Chrome trace. ``ThroughputMeter`` is the driver's iters/s
and rays/s counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class PrintExecTime:
    """Scoped wall-clock timer: ``with PrintExecTime("name"):`` prints
    ``[name] <ms> ms`` on exit when enabled (reference utils/config.py:
    49-64); the seconds stay in ``elapsed``."""

    enabled = True

    def __init__(self, name: str = "block", enabled: Optional[bool] = None):
        self.name = name
        self._enabled = PrintExecTime.enabled if enabled is None else enabled

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self._enabled:
            print(f"[{self.name}] {self.elapsed * 1000:.1f} ms", flush=True)
        return False


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
