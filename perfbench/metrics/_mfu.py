"""The whole step's share (%) of the H100's peaks: the least time its
work needs, counted from shapes and counts whatever implements it (the
FPN's bf16 convolutions at 989 TFLOP/s, each control QP's fp32
factorisation and iterations at 67 TFLOP/s), over the requests' own
walls (their latencies) in the traced run's unprofiled stretch."""

from perfbench.metrics._fpn_flops import fpn_flops
from perfbench.metrics._peaks import BF16_FLOP_PER_S, FP32_FLOP_PER_S
from perfbench.metrics._qp_work import qp_flops


def step_mfu(ctx):
    t = ctx["trace"]
    if not t or not t["requests"]:
        return None
    c, cell = t["counters"], ctx["cell"]
    s = cell.shapes()
    least = qp_flops(s["n"], s["m"], c["qp_solves"], c["qp_iterations"]) / FP32_FLOP_PER_S
    if c.get("frames"):
        h, w = cell.frame_shape()
        least += c["frames"] * fpn_flops(h, w) / BF16_FLOP_PER_S
    return 100.0 * least / sum(ctx["latencies_s"])
