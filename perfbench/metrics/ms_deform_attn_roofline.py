"""The deformable attention's sampling's share (%) of its least time a
frame: the six encoder layers' sampling (``_mask2former_flops``) at the
fp32 CUDA-core peak, no tensor core doing it, or its bytes (the value,
the offsets and the logits read once, the output written once, bf16)
at the HBM peak where that is longer, over the device time a frame of
the kernels named ``ms_deform_attn``, whichever implements them. None
where none ran."""

from perfbench.metrics._mask2former_flops import mask2former_flops
from perfbench.metrics._peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

FRAGMENT = "ms_deform_attn"


def read(ctx):
    t = ctx["trace"] or {}
    table = t.get("kernels") or {}
    busy = sum(row[0] for name, row in table.items() if FRAGMENT in name)
    if not busy or not t.get("profiled_requests"):
        return None
    cell = ctx["cell"]
    work = mask2former_flops(*cell.frame_shape(), cell.config)
    least = max(work["sampling"] / FP32_FLOP_PER_S, work["sampling_bytes"] / HBM_BYTES_PER_S)
    return 100.0 * least * t["profiled_requests"] / busy
