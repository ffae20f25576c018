"""The 95th percentile of the step's period over the traced run's window:
milliseconds between CUDA events recorded in the stream at consecutive
steps' starts (a steadier statistic beside the rate, not a decider)."""

import statistics


def read(ctx):
    if len(ctx.step_ms) < 20:
        return None
    return statistics.quantiles(ctx.step_ms, n=20)[-1]
