"""The window attention's share (%) of its least time a frame: the Swin
blocks' real queries' Q K^T and P V (``_swin_flops``) at the bf16 peak,
or their bytes (q, k and v read once, the output written once, bf16) at
the HBM peak where that is longer, over the device time a frame of the
kernels whose name holds ``window_attention``, whichever implements
them. None where none ran."""

from perfbench.metrics._peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from perfbench.metrics._swin_flops import swin_flops

FRAGMENT = "window_attention"


def read(ctx):
    t = ctx["trace"] or {}
    table = t.get("kernels") or {}
    busy = sum(row[0] for name, row in table.items() if FRAGMENT in name)
    if not busy or not t.get("profiled_requests"):
        return None
    cell = ctx["cell"]
    work = swin_flops(*cell.frame_shape(), cell.config)
    least = max(work["attention"] / BF16_FLOP_PER_S, work["attention_bytes"] / HBM_BYTES_PER_S)
    return 100.0 * least * t["profiled_requests"] / busy
