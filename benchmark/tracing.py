"""A profiled stretch of iterations and what its chrome trace says.

``record`` runs ``n`` iterations under ``torch.profiler`` (CPU and CUDA
activities) inside a ``bench.window`` annotation, each inside a
``bench.step`` annotation, ending on a host read, and writes the trace to
a file it deletes once read. ``Trace`` holds the device operations (the
``kernel``, ``gpu_memset`` and ``gpu_memcpy`` events, the categories the
port's ``tools/trace.py device_ops`` sums), the CUDA runtime calls and the
host operations that fall in the window.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def record(iterate, n: int, end_read):
    """Profile ``iterate(i)`` for i < n, then ``end_read()``; returns the
    parsed Trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for i in range(n):
                with record_function("bench.step"):
                    iterate(i)
            end_read()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.remove(path)
    return Trace(events["traceEvents"] if isinstance(events, dict)
                 else events, n)


class Trace:
    def __init__(self, events: list, steps: int):
        self.steps = steps
        win = [e for e in events if e.get("ph") == "X"
               and e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace has no bench.window annotation")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device, self.runtime, self.host = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts < self.t0 or ts > self.t1:
                continue
            row = (e.get("name", ""), ts, dur)
            if cat in DEVICE_CATS:
                self.device.append(row)
            elif cat in HOST_CATS:
                self.host.append(row)
                if cat == "cuda_runtime":
                    self.runtime.append(row)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals in the window."""
        spans = sorted((ts, min(ts + d, self.t1)) for _, ts, d in self.device)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def totals(self, match=None) -> dict:
        """{name: [seconds, count]} of the device operations whose name
        contains one of ``match`` (all without it)."""
        out: dict = {}
        for name, _, d in self.device:
            if match is None or any(m in name for m in match):
                t = out.setdefault(name, [0.0, 0])
                t[0] += d / 1e6
                t[1] += 1
        return out

    def idle_gaps(self, k: int = 10) -> list:
        """The k longest gaps between device operations in the window, each
        named by the innermost host operation running at its start."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:k]
        out = []
        for length, start in gaps:
            inner = [(ts, name) for name, ts, d in self.host
                     if ts <= start < ts + d]
            out.append([max(inner)[1] if inner else "host", length / 1e6])
        return out
