"""Share (%) of the H100's peaks that a B = 1 request's work needs over
its wall (``_mfu``)."""

from perfbench.metrics._mfu import step_mfu


def read(ctx):
    return step_mfu(ctx)
