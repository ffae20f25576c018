"""The row gathers' boolean masks a step (``_RowGather``'s forward, its
recompute and its backward each wait for the device to count the
foreground): ``tssplat.sync.row_gather`` spans over the profiled
stretch's steps."""

from benchmark.spans import count_per_step


def read(ctx):
    return count_per_step(ctx, "tssplat.sync.row_gather")
