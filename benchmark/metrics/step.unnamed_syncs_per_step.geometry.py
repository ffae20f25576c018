"""The runtime's waits for the device (``step.host_syncs_per_step``'s
calls) a step inside a ``tssplat.step`` span and inside no
``tssplat.sync.*`` span: the step's syncs the program does not name."""

from benchmark.spans import unnamed_syncs_per_step


def read(ctx):
    return unnamed_syncs_per_step(ctx)
