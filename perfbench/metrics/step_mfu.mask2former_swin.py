"""Share (%) of the H100's bf16 peak that a frame's Mask2Former-Swin-L
forward needs (``_swin_flops``' tensor-core work, 989 TFLOP/s), frames
over the requests' own walls (their latencies) in the traced run's
unprofiled stretch."""

from perfbench.metrics._peaks import BF16_FLOP_PER_S
from perfbench.metrics._swin_flops import swin_flops


def read(ctx):
    t = ctx["trace"]
    if not t or not t["counters"].get("frames"):
        return None
    cell = ctx["cell"]
    least = t["counters"]["frames"] * swin_flops(*cell.frame_shape(), cell.config)["total"] / BF16_FLOP_PER_S
    return 100.0 * least / sum(ctx["latencies_s"])
