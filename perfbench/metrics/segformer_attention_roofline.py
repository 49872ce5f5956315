"""SegFormer's attention's share (%) of its least time a frame: Q K^T
and P V of every block at the bf16 peak, or Q, K, V and the output
moved once at the HBM peak where that is longer (``_segformer_flops``),
over the device time a frame of the kernels that compute it, whichever
implements them: the kernels whose name holds one of ``FRAGMENTS``
(PyTorch's FlashAttention-2, memory-efficient and cuDNN attention, and
a hand-written kernel named ``segformer_attention``). None where none
ran."""

from perfbench.metrics._peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from perfbench.metrics._segformer_flops import segformer_flops

FRAGMENTS = ("flash_fwd", "fmha", "AttentionKernel", "sdpa", "segformer_attention")


def read(ctx):
    t = ctx["trace"] or {}
    table = t.get("kernels") or {}
    busy = sum(row[0] for name, row in table.items() if any(f in name for f in FRAGMENTS))
    if not busy or not t.get("profiled_requests"):
        return None
    cell = ctx["cell"]
    work = segformer_flops(*cell.frame_shape(), cell.config)
    least = max(work["attention"] / BF16_FLOP_PER_S, work["attention_bytes"] / HBM_BYTES_PER_S)
    return 100.0 * least * t["profiled_requests"] / busy
