"""The driver's throughput meter (``ThroughputMeter``,
``tssplat_tpu/utils/profiling.py:52-101``)."""

from __future__ import annotations

import time
from typing import Optional


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
