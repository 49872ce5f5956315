"""Multiply-add operations (2 a product) of the FPN-ResNet18 forward at
a frame size: its convolutions, counted from the reference model's
shapes on the meta device."""

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def fpn_flops(height: int, width: int, classes: int = 10) -> float:
    from perfbench.reference.fpn import FPN

    count = [0.0]
    conv = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0, *args, **kwargs):
        y = conv(x, w, b, stride, padding, *args, **kwargs)
        count[0] += 2.0 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    shapes = _shapes(classes)
    meta = {k: _tree(v) for k, v in shapes.items()}
    F.conv2d = counting
    try:
        FPN(meta).logits(torch.zeros((height, width, 3), dtype=torch.uint8, device="meta"))
    finally:
        F.conv2d = conv
    return count[0]


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.zeros(node, device="meta")


def _shapes(classes: int) -> dict:
    """The checkpoint's tree of shapes (kernels HWIO)."""
    def conv(k, cin, cout, bias=False):
        d = {"kernel": (k, k, cin, cout)}
        if bias:
            d["bias"] = (cout,)
        return d

    bn = lambda c: {"scale": (c,), "bias": (c,)}  # noqa: E731
    stat = lambda c: {"mean": (c,), "var": (c,)}  # noqa: E731
    enc, st = {"conv1": conv(7, 3, 64), "bn1": bn(64)}, {"bn1": stat(64)}
    cin = 64
    for i, (c, s) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
        for j in range(2):
            blk = {"conv1": conv(3, cin if j == 0 else c, c), "bn1": bn(c), "conv2": conv(3, c, c), "bn2": bn(c)}
            bst = {"bn1": stat(c), "bn2": stat(c)}
            if j == 0 and (cin != c or s != 1):
                blk["downsample_conv"], blk["downsample_bn"] = conv(1, cin, c), bn(c)
                bst["downsample_bn"] = stat(c)
            enc[f"layer{i + 1}_{j}"], st[f"layer{i + 1}_{j}"] = blk, bst
        cin = c
    params = {"encoder": enc, "head": conv(1, 128, classes, True)}
    for name, c in (("p5", 512), ("p4", 256), ("p3", 128), ("p2", 64)):
        params[name] = conv(1, c, 256, True)
    for name, ups in (("s5", 3), ("s4", 2), ("s3", 1), ("s2", 0)):
        params[name] = {f"block{i}": {"conv": conv(3, 256 if i == 0 else 128, 128),
                                      "gn": {"scale": (128,), "bias": (128,)}} for i in range(max(1, ups))}
    return {"params": params, "batch_stats": {"encoder": st}}
