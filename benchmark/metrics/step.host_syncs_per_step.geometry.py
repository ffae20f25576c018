"""Times a step the host waits for the device: the CUDA runtime's stream,
event and device synchronisations and its synchronous copies (a tensor's
``item()`` or ``nonzero()``, the binning's sizes) in the profiled stretch,
over its steps."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemcpyFromSymbol")


def read(ctx):
    n = sum(1 for name, _, _ in ctx.trace.runtime if name in SYNC_CALLS)
    return n / ctx.steps
