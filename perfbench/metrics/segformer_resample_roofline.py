"""SegFormer's head resample's share (%) of its least time a frame: the
head's four projected parts (``decoder_hidden_size`` channels at each
stage's grid) read once and their concatenation at stage 1's grid
written once, in bfloat16, at the HBM peak, over the device time a frame
of the kernels that do that work, whichever implements them: PyTorch's
channels-last bilinear resizes and its concatenation of 2-byte elements,
or the hand-written ``segformer_resample``. The frame's other
concatenations (25 small ones a frame, of 4-byte elements, 0.035 ms on
an H100) are not the head's and are left out. None where none ran."""

from perfbench.metrics._peaks import HBM_BYTES_PER_S

FRAGMENTS = ("upsample_bilinear2d_nhwc", "segformer_resample")
CAT, TWO_BYTES = "CatArrayBatchedCopy", "OpaqueType<2u>"  # torch.cat's kernel, on bf16
BYTES = 2  # bfloat16


def is_head(name: str) -> bool:
    return any(f in name for f in FRAGMENTS) or (CAT in name and TWO_BYTES in name)


def resample_bytes(height: int, width: int, shape: dict) -> float:
    """The four parts read once and the concatenation written once."""
    grids = []
    for s in shape["strides"]:
        height, width = -(-height // s), -(-width // s)
        grids.append(height * width)
    return BYTES * shape["decoder_hidden_size"] * (sum(grids) + len(grids) * grids[0])


def read(ctx):
    t = ctx["trace"] or {}
    table = t.get("kernels") or {}
    busy = sum(row[0] for name, row in table.items() if is_head(name))
    if not busy or not t.get("profiled_requests"):
        return None
    cell = ctx["cell"]
    least = resample_bytes(*cell.frame_shape(), cell.config) / HBM_BYTES_PER_S
    return 100.0 * least * t["profiled_requests"] / busy
