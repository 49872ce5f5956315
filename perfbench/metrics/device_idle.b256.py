"""Idle share (%) of the device in a B = 256 step (``_idle``)."""

from perfbench.metrics._idle import idle


def read(ctx):
    return idle(ctx)
