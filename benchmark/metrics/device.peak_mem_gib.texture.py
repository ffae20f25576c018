"""The allocator's peak (``torch.cuda.max_memory_allocated``) over the
traced run's window, GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30
