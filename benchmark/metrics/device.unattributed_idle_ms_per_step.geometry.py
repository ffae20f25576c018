"""Device idle milliseconds a step in gaps that start inside no layer span
of the program: glue code inside ``tssplat.step``, the harness between
steps, the loss read that ends the stretch (``benchmark/spans.py``). With
the seven ``*.idle_ms_per_step.geometry`` layers it sums to the window's
idle time."""

from benchmark.spans import idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, None)
