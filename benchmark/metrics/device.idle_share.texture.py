"""Per cent of the profiled window in which no device operation runs: 100
x (1 - the union of the device operations' intervals / the window)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
