"""The binning's host reads of its pair total a step: ``tssplat.sync.binning``
spans (one a chunk) over the profiled stretch's steps."""

from benchmark.spans import count_per_step


def read(ctx):
    return count_per_step(ctx, "tssplat.sync.binning")
