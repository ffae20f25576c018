"""Host milliseconds an iteration in the loader's ``dataloader(it, 0)``
(the gather of the batch's views on the device, as enqueued), averaged
over the traced run's window; the benchmark's own span around the call."""


def read(ctx):
    if not ctx.loader_ms:
        return None
    return sum(ctx.loader_ms) / len(ctx.loader_ms)
