"""The chain-edges kernel's share (%) of its least time: the (H, W)
uint8 mask read once and each row's left and right columns (int64) and
validity (bool) written once, at the HBM peak, over its device time."""

from perfbench.metrics._kernels import per_launch
from perfbench.metrics._peaks import HBM_BYTES_PER_S


def read(ctx):
    seen = per_launch(ctx, "track_chain_edges")
    if seen is None:
        return None
    h, w = ctx["cell"].frame_shape()
    return 100.0 * (h * w + h * 17) / HBM_BYTES_PER_S / seen[0]
