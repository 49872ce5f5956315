"""Multiply-add operations (2 a product) of the SegFormer forward at a
frame size, counted from the configuration's shape (``transformers``'
``SegformerConfig`` names): every convolution and linear layer, and the
attention's two products, Q K^T and P V. The elementwise work (norms,
softmax, GELU, resizing) is not counted. Also the attention's bytes in
bfloat16: Q, K and V read once and its output written once."""

from __future__ import annotations


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def segformer_flops(height: int, width: int, shape: dict) -> dict:
    """{"encoder", "attention" (of the encoder's), "decoder", "fuse" (of
    the decoder's: the 1x1 convolution over the concatenation), "total"}
    in operations a frame, and "attention_bytes"."""
    enc = att = att_bytes = 0.0
    h, w, cin = height, width, shape.get("num_channels", 3)
    grids = []
    for i, c in enumerate(shape["hidden_sizes"]):
        k, s = shape["patch_sizes"][i], shape["strides"][i]
        h, w = _ceil(h, s), _ceil(w, s)
        t = h * w
        enc += 2.0 * t * c * cin * k * k  # the patch embedding
        r = shape["sr_ratios"][i]
        kv = (h // r) * (w // r) if r > 1 else t
        hidden = c * shape["mlp_ratios"][i]
        block = (2.0 * t * c * c  # Q
                 + (2.0 * kv * c * c * r * r if r > 1 else 0.0)  # the reduction
                 + 2 * 2.0 * kv * c * c  # K, V
                 + 2 * 2.0 * t * kv * c  # Q K^T and P V over every head
                 + 2.0 * t * c * c  # the output projection
                 + 2 * 2.0 * t * c * hidden  # the Mix-FFN's two linears
                 + 2.0 * t * hidden * 9)  # its depthwise 3x3
        enc += shape["depths"][i] * block
        att += shape["depths"][i] * 2 * 2.0 * t * kv * c
        att_bytes += shape["depths"][i] * 2 * (2 * t * c + 2 * kv * c)
        grids.append((t, c))
        cin = c
    d = shape["decoder_hidden_size"]
    t1 = grids[0][0]
    fuse = 2.0 * t1 * d * len(grids) * d
    dec = sum(2.0 * t * c * d for t, c in grids) + fuse + 2.0 * t1 * d * shape["num_labels"]
    return {"encoder": enc, "attention": att, "decoder": dec, "fuse": fuse, "total": enc + dec,
            "attention_bytes": att_bytes}
