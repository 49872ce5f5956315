"""Share (%) of the H100's bf16 peak that a frame's Mask2Former forward
needs (``_mask2former_flops``' tensor-core work, 989 TFLOP/s), frames
over the requests' own walls (their latencies) in the traced run's
unprofiled stretch."""

from perfbench.metrics._mask2former_flops import mask2former_flops
from perfbench.metrics._peaks import BF16_FLOP_PER_S


def read(ctx):
    t = ctx["trace"]
    if not t or not t["counters"].get("frames"):
        return None
    cell = ctx["cell"]
    least = t["counters"]["frames"] * mask2former_flops(*cell.frame_shape(), cell.config)["total"] / BF16_FLOP_PER_S
    return 100.0 * least / sum(ctx["latencies_s"])
