"""The program's own spans in a profiled stretch, for the per-layer metrics
that read them.

The port names its layers and the statements where its host waits for the
device with ``tssplat.*`` ranges of the profiler's trace
(``tssplat_torch/utils/profiling.py span``): they are ``user_annotation``
rows of ``Trace.host``, on the clock of the CUDA runtime calls and the
device's operations. A layer span is one of ``LAYERS``; a
``tssplat.sync.<site>`` span wraps one statement that waits. Nothing here
imports the port: a trace without the spans (a program that records none)
gives None.

Device idle time is put down to layers so: each gap between the device's
busy intervals in the window goes, whole, to the innermost layer span (the
latest started of those open, on any thread) at the gap's start, or to
none (``None``: glue inside ``tssplat.step``, the harness, the loss read).
A sync span is not a layer: its gaps go to the layer around it.
"""

from __future__ import annotations

from .manifest import load

LAYERS = ("loader", "visibility", "binning", "render", "energy", "backward",
          "optim")
STEP = "tssplat.step"
SYNC = "tssplat.sync."


def sync_calls() -> tuple:
    """The CUDA runtime calls that wait for the device: the ``SYNC_CALLS``
    of ``metrics/step.host_syncs_per_step.geometry.py``."""
    return tuple(load("metrics", "step.host_syncs_per_step.geometry")
                 .SYNC_CALLS)


def rows(trace, name=None, prefix=None) -> list:
    """(start, end) in microseconds of the host rows named ``name``, or
    whose name starts with ``prefix``, sorted by start."""
    return sorted((ts, ts + d) for n, ts, d in trace.host
                  if n == name or (prefix is not None
                                   and n.startswith(prefix)))


def count_per_step(ctx, name: str):
    """Spans named ``name`` a step of the stretch, or None without one."""
    n = len(rows(ctx.trace, name))
    return n / ctx.steps if n else None


def ms_per_step(ctx, name=None, prefix=None):
    """Summed milliseconds of the spans named ``name`` (or starting with
    ``prefix``) a step, or None without one."""
    found = rows(ctx.trace, name, prefix)
    if not found:
        return None
    return sum(b - a for a, b in found) / 1e3 / ctx.steps


def _innermost(spans: list, points: list) -> list:
    """For each of the sorted ``points``, the label of the latest-started
    span (start, end, label) open there (start <= p < end), or None."""
    spans = sorted(spans)
    out, active, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > p]
        out.append(max(active)[2] if active else None)
    return out


def idle_gaps(trace) -> list:
    """(start, length) in microseconds of every gap between the device's
    busy intervals in the window, in order; their lengths sum to the
    window's idle time."""
    edges = [trace.t0] + [x for ab in trace.busy_intervals() for x in ab] \
        + [trace.t1]
    return [(edges[i], edges[i + 1] - edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def idle_by_layer(trace) -> dict:
    """Idle microseconds of the window by layer (``LAYERS``, and None for
    the gaps in no layer span); {} when the trace holds no layer span."""
    spans = [(a, b, layer) for layer in LAYERS
             for a, b in rows(trace, "tssplat." + layer)]
    if not spans:
        return {}
    gaps = idle_gaps(trace)
    out: dict = {}
    for (_, length), layer in zip(gaps, _innermost(spans,
                                                   [g for g, _ in gaps])):
        out[layer] = out.get(layer, 0.0) + length
    return out


def idle_ms_per_step(ctx, layer):
    """Device idle milliseconds a step put down to ``layer`` (None: the
    gaps in no layer span), or None where the trace holds none of that
    layer's spans (for None: no layer span at all)."""
    tr = ctx.trace
    if layer is not None and not rows(tr, "tssplat." + layer):
        return None
    by_layer = idle_by_layer(tr)
    if not by_layer:
        return None
    return by_layer.get(layer, 0.0) / 1e3 / ctx.steps


def unnamed_syncs_per_step(ctx):
    """The runtime's waits for the device a step that fall inside a
    ``tssplat.step`` span and inside no ``tssplat.sync.*`` span, or None
    without a step span."""
    tr = ctx.trace
    steps = [(a, b, "step") for a, b in rows(tr, STEP)]
    if not steps:
        return None
    names = sync_calls()
    calls = sorted(ts for n, ts, _ in tr.runtime if n in names)
    sites = [(a, b, "sync") for a, b in rows(tr, prefix=SYNC)]
    n = sum(1 for in_step, in_site in zip(_innermost(steps, calls),
                                          _innermost(sites, calls))
            if in_step and not in_site)
    return n / ctx.steps
