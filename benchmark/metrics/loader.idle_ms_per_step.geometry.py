"""Device idle milliseconds a step put down to the ``tssplat.loader``
layer: the gaps between the device's busy intervals that start while it is
the innermost layer span open (``benchmark/spans.py``)."""

from benchmark.spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, "loader")
