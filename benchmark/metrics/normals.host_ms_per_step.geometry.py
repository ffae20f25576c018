"""Host milliseconds a step in the program's ``tssplat.normals`` spans (the
normal shading of ``render/pipeline.py render_views``: the vertex normals,
the Wonder3D flip and its copy to the device, the interpolation at the
winners, as enqueued) over the profiled stretch; None where the step fits
no normals, or the program records no such span."""

from benchmark.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "tssplat.normals")
