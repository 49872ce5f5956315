"""Operations (2 a multiply-add) of the Mask2Former-Swin-L forward at a
frame size, counted from the configuration's shape (``transformers``'
``Mask2FormerConfig`` names, the backbone's ``SwinConfig``'s under
``backbone_config``): the Swin backbone as published (the patch
embedding; the qkv and proj Linears and the attention products, Q K^T
and P V, over the windows of the padded map; the MLP Linears of the
real tokens; the merging Linears), then the pixel decoder, the decoder
and semantic inference as ``_mask2former_flops`` counts them for the
backbone's stage widths; the elementwise work is not counted. Apart
from them, the least work of the window attention: ``attention``, Q K^T
and P V of the real queries over their windows' keys, the padding's
included, and ``attention_bytes`` in bfloat16, each real token's q, k
and v read once and its output written once."""

from __future__ import annotations

from perfbench.metrics._mask2former_flops import mask2former_flops


def swin_flops(height: int, width: int, shape: dict) -> dict:
    """{"backbone", "pixel_decoder", "decoder", "semantic", "total"} in
    operations a frame; "attention" (operations) and "attention_bytes"
    a frame. H and W divisible by 32."""
    b = shape["backbone_config"]
    patch, window = b["patch_size"], b["window_size"]
    widths = [b["embed_dim"] * 2 ** i for i in range(len(b["depths"]))]
    h, w = height // patch, width // patch
    backbone = 2.0 * h * w * widths[0] * 3 * patch * patch
    attention = attention_bytes = 0.0
    for i, (c, depth) in enumerate(zip(widths, b["depths"])):
        if i > 0:
            h, w = h // 2, w // 2
            backbone += 2.0 * h * w * 2 * c * c  # the merging: 4 C / 2 to C
        t = h * w
        padded = -(-h // window) * window * -(-w // window) * window
        per_query = 2.0 * 2 * window * window * c  # Q K^T and P V over a window's keys
        backbone += depth * (2.0 * padded * c * 4 * c + padded * per_query + 2.0 * t * c * 2 * int(c * b["mlp_ratio"]))
        attention += depth * t * per_query
        attention_bytes += depth * 2.0 * t * 4 * c
    rest = mask2former_flops(height, width, {**shape, "backbone_config": {
        "embedding_size": 0, "hidden_sizes": widths, "depths": [0] * len(widths)}})
    out = {"backbone": backbone, "attention": attention, "attention_bytes": attention_bytes}
    out.update((k, rest[k]) for k in ("pixel_decoder", "decoder", "semantic"))
    out["total"] = backbone + out["pixel_decoder"] + out["decoder"] + out["semantic"]
    return out
