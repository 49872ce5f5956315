"""The ADMM chunk kernel's share (%) of its least time at B = 1: each
input read once, each output written once, against its fp32 operations
(``_chunk_bound``), over the kernel's own device time a launch."""

from perfbench.metrics._roofline import admm_chunk


def read(ctx):
    return admm_chunk(ctx)
