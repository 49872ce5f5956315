"""Idle share (%) of the device in a B = 1 request (``_idle``)."""

from perfbench.metrics._idle import idle


def read(ctx):
    return idle(ctx)
