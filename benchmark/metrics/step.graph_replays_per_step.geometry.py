"""Replays of the geometry step's CUDA graph a step: the program's
``tssplat.graph`` spans over the profiled stretch's steps. 1.0 where every
step replays its graph; lower where a step ran its body eagerly; None
where the program records no such span (a program without the graph)."""

from benchmark.spans import count_per_step


def read(ctx):
    return count_per_step(ctx, "tssplat.graph")
