"""Host milliseconds a step in the program's ``tssplat.loader`` spans (the
loader's gather of the batch's views, as enqueued) over the profiled
stretch: the in-program twin of ``loader.host_ms_per_iter.geometry``."""

from benchmark.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tssplat.loader")
