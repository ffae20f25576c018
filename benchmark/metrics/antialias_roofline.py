"""Per cent of its roofline the silhouette antialias reaches: the least
time of one step's forward and backward antialias work
(``benchmark/yardstick.py antialias_work`` on the pair counts of every
view at the traced run's parameters), each at the card's published peaks,
over the device time of the kernels named below in a step of the profiled
stretch (the forward runs once a step; the work counts it once)."""

from benchmark.yardstick import antialias_work, least_seconds

KERNELS = ("aa_fwd_kernel", "aa_bwd_kernel")


def read(ctx):
    spent = sum(t[0] for t in ctx.trace.totals(KERNELS).values())
    if spent <= 0 or ctx.aa_counts is None:
        return None
    fwd, bwd = antialias_work(ctx.aa_counts, ctx.views * ctx.res * ctx.res)
    least = least_seconds(*fwd) + least_seconds(*bwd)
    return 100.0 * least / (spent / ctx.steps)
