"""Device operations a step (kernels, memsets and copies) in the profiled
stretch of the geometry stage."""


def read(ctx):
    return len(ctx.trace.device) / ctx.steps
