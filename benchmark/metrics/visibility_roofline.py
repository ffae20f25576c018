"""Per cent of its roofline the step's visibility kernels reach: the least
time of one step's visibility work (``benchmark/yardstick.py
visibility_work``: every face's clip rows read once, every pixel's outputs
the step needs written once — with the winner rows on the silhouette path,
the id alone on the shaded path) at the card's published peaks, over the
device time of the kernels named below in a step of the profiled
stretch."""

from benchmark.yardstick import least_seconds, visibility_work

KERNELS = ("vis_capped_kernel", "vis_kernel")


def read(ctx):
    spent = sum(t[0] for t in ctx.trace.totals(KERNELS).values())
    if spent <= 0:
        return None
    work = visibility_work(ctx.views, ctx.res, ctx.faces, not ctx.shaded)
    return 100.0 * least_seconds(*work) / (spent / ctx.steps)
