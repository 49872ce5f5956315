"""Plain reference of the segmenter: FPN-ResNet18 (Kirillov et al.'s
panoptic FPN head over a ResNet-18 encoder) as functional PyTorch, on
the weights of a Flax msgpack checkpoint read here with ``msgpack``.

The layout is the shipped checkpoint's: a ResNet-18 encoder (7x7 stem,
max pool, four stages of two basic blocks with BatchNorm on running
statistics), 256-channel lateral 1x1 convolutions with a nearest 2x
top-down path, four 128-channel segmentation branches (3x3 convolution,
GroupNorm of 32 groups, ReLU, nearest 2x upsampling, as many as the
level needs) summed, a 1x1 classifier and a 4x bilinear upsampling with
aligned corners. Explicit paddings as Flax's 'SAME' gives them. The
frame is (H, W, 3) uint8 divided by 255; the drivable mask is class 1.

It computes in float32 with TF32 off. ``fp8=True`` is the control: every
convolution's input and weight rounded to float8 e4m3 with a scale per
tensor, the precision below the bfloat16 the configuration states.
"""

from __future__ import annotations

import pathlib

import msgpack
import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _array(data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        return (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape)


def _hook(code: int, data: bytes):
    if code == 1:
        return _array(data)
    if code == 3:
        return _array(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def load(path: str | pathlib.Path, device) -> dict:
    """{'params': ..., 'batch_stats': ...} of the checkpoint as float32
    tensors on ``device`` (kernels stay HWIO as stored)."""
    tree = msgpack.unpackb(pathlib.Path(path).read_bytes(), ext_hook=_hook, raw=False)

    def to_t(node):
        if isinstance(node, dict):
            return {k: to_t(v) for k, v in node.items()}
        return torch.as_tensor(np.asarray(node, np.float32), device=device)

    return to_t(tree)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.amax(torch.abs(t)), min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class FPN:
    def __init__(self, variables: dict, fp8: bool = False):
        self.p = variables["params"]
        self.s = variables.get("batch_stats", {})
        self.fp8 = fp8

    def conv(self, x, node, stride=1, bias=False):
        w = node["kernel"].permute(3, 2, 0, 1)
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        k = w.shape[-1]
        return F.conv2d(x, w, node["bias"] if bias else None, stride=stride, padding=k // 2)

    @staticmethod
    def bn(x, prm, st):
        inv = torch.rsqrt(st["var"] + 1e-5) * prm["scale"]
        return (x - st["mean"][:, None, None]) * inv[:, None, None] + prm["bias"][:, None, None]

    def block(self, x, prm, st, stride):
        y = F.relu(self.bn(self.conv(x, prm["conv1"], stride), prm["bn1"], st["bn1"]))
        y = self.bn(self.conv(y, prm["conv2"]), prm["bn2"], st["bn2"])
        if "downsample_conv" in prm:
            x = self.bn(self.conv(x, prm["downsample_conv"], stride),
                        prm["downsample_bn"], st["downsample_bn"])
        return F.relu(y + x)

    def branch(self, x, prm, n_up):
        for i in range(max(1, n_up)):
            b = prm[f"block{i}"]
            x = F.relu(F.group_norm(self.conv(x, b["conv"]), 32, b["gn"]["scale"], b["gn"]["bias"], 1e-5))
            if n_up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        return x

    @torch.no_grad()
    def logits(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (num_classes, H, W) float32 logits."""
        e, es = self.p["encoder"], self.s["encoder"]
        x = (image.to(torch.float32) / 255.0).permute(2, 0, 1)[None]
        x = F.relu(self.bn(self.conv(x, e["conv1"], 2), e["bn1"], es["bn1"]))
        x = F.pad(x, (1, 1, 1, 1), value=-torch.inf)
        x = F.max_pool2d(x, 3, stride=2)
        feats = []
        for i, stride in enumerate((1, 2, 2, 2)):
            x = self.block(x, e[f"layer{i + 1}_0"], es[f"layer{i + 1}_0"], stride)
            x = self.block(x, e[f"layer{i + 1}_1"], es[f"layer{i + 1}_1"], 1)
            feats.append(x)
        c2, c3, c4, c5 = feats
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        p5 = self.conv(c5, self.p["p5"], bias=True)
        p4 = self.conv(c4, self.p["p4"], bias=True) + up(p5)
        p3 = self.conv(c3, self.p["p3"], bias=True) + up(p4)
        p2 = self.conv(c2, self.p["p2"], bias=True) + up(p3)
        x = (self.branch(p5, self.p["s5"], 3) + self.branch(p4, self.p["s4"], 2)
             + self.branch(p3, self.p["s3"], 1) + self.branch(p2, self.p["s2"], 0))
        x = self.conv(x, self.p["head"], bias=True)
        return F.interpolate(x, scale_factor=4, mode="bilinear", align_corners=True)[0]

    def drivable(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W) uint8: 1 where class 1 wins."""
        return (torch.argmax(self.logits(image), dim=0) == 1).to(torch.uint8)
