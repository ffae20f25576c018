"""Host milliseconds a step blocked on the device at the program's named
sites: the summed durations of every ``tssplat.sync.*`` span over the
profiled stretch's steps."""

from benchmark.spans import SYNC, ms_per_step


def read(ctx):
    return ms_per_step(ctx, prefix=SYNC)
