"""Operations (2 a multiply-add) of the Mask2Former-R50 forward at a frame
size, counted from the configuration's shape (``transformers``'
``Mask2FormerConfig`` names, the backbone's under ``backbone_config``):
every convolution and linear layer, the decoder's attention products
(Q K^T and P V), the mask products with the mask features, and semantic
inference's product; the elementwise work (norms, softmax, resizes,
sigmoids) is not counted. Apart from them, the deformable attention's
sampling (``sampling``, on the CUDA cores: each point's four-tap
bilinear, 7 operations a channel, and its weighted sum, 2) and its bytes
in bfloat16 (``sampling_bytes``: the value read once, the offsets and
the attention logits read once as the linears give them, the output
written once)."""

from __future__ import annotations


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mask2former_flops(height: int, width: int, shape: dict) -> dict:
    """{"backbone", "pixel_decoder", "decoder", "semantic", "total"} in
    operations a frame (tensor-core work), and "sampling" (operations)
    and "sampling_bytes" a frame."""
    b = shape["backbone_config"]
    h, w = _ceil(height, 2), _ceil(width, 2)
    stem = b["embedding_size"]
    backbone = 2.0 * h * w * stem * 3 * 49
    h, w = _ceil(h, 2), _ceil(w, 2)  # the max pooling
    grids, cin = [], stem
    for i, (cout, depth) in enumerate(zip(b["hidden_sizes"], b["depths"])):
        inner = cout // 4
        t_in = h * w
        if i > 0:
            h, w = _ceil(h, 2), _ceil(w, 2)
        t = h * w
        for j in range(depth):
            c, ti = (cin, t_in) if j == 0 else (cout, t)
            backbone += 2.0 * (ti * c * inner + t * inner * inner * 9 + t * inner * cout)
            if j == 0:
                backbone += 2.0 * t * c * cout  # the shortcut
        grids.append((t, cout))
        cin = cout
    d, levels = shape["feature_size"], shape["num_feature_levels"]
    heads, points = shape["num_attention_heads"], shape["encoder_n_points"]
    enc = grids[1:]
    S = sum(t for t, _ in enc)
    ffn = shape["encoder_feedforward_dim"]
    pixel = sum(2.0 * t * c * d for t, c in enc)  # the input projections
    per_layer = 2.0 * S * d * (heads * levels * points * 3 + 2 * d + 2 * ffn)
    t2 = grids[0][0]
    pixel += shape["encoder_layers"] * per_layer
    pixel += 2.0 * t2 * grids[0][1] * d + 2.0 * t2 * d * d * 9 + 2.0 * t2 * d * shape["mask_feature_size"]
    sampling = shape["encoder_layers"] * S * heads * levels * points * (d // heads) * 9.0
    sampling_bytes = shape["encoder_layers"] * 2.0 * S * (d + heads * levels * points * 3 + d)
    hid, Q, m = shape["hidden_dim"], shape["num_queries"], shape["mask_feature_size"]
    n_layers = shape["decoder_layers"] - 1
    predictions = n_layers + 1
    dec = predictions * (2.0 * Q * hid * (shape["num_labels"] + 1) + 2.0 * Q * hid * hid * 2
                         + 2.0 * Q * hid * m + 2.0 * Q * m * t2)
    keys = [t for t, _ in enc[::-1]]  # 1/32, 1/16, 1/8
    for i in range(n_layers):
        k = keys[i % levels]
        dec += 2.0 * hid * hid * (Q + 2 * k) + 2 * 2.0 * Q * k * hid + 2.0 * Q * hid * hid  # cross
        dec += 4 * 2.0 * Q * hid * hid + 2 * 2.0 * Q * Q * hid  # self
        dec += 2 * 2.0 * Q * hid * shape["dim_feedforward"]  # FFN
    semantic = 2.0 * shape["num_labels"] * Q * height * width
    return {"backbone": backbone, "pixel_decoder": pixel, "decoder": dec, "semantic": semantic,
            "total": backbone + pixel + dec + semantic, "sampling": sampling, "sampling_bytes": sampling_bytes}
