"""FPN-ResNet18 semantic segmentation model as PyTorch modules.

Counterpart of ``acmpc_tpu/models/fpn_resnet18.py`` (the Flax model):
a ResNet-18 encoder, a 256-channel FPN top-down decoder, 128-channel
segmentation blocks merged by summation, and a 1x1 classifier upsampled
4x (bilinear, corners aligned) to full resolution. The model takes and
returns NHWC at its boundary, as the Flax model does; inside it runs
NCHW tensors in ``channels_last`` memory, the layout cuDNN's bf16
convolutions prefer, so the permutes at the boundary are free views.

Semantics kept from the Flax model: explicit paddings (1 on the 3x3
convolutions, 3 on the 7x7 stem, none on the 1x1 ones, which is what
Flax's 'SAME' gives there); max pooling padded with -inf; nearest 2x
upsampling; BatchNorm (running statistics) and GroupNorm (32 groups)
with eps 1e-5; dropout at 0.2 before the classifier, switched by the
``train`` argument alone; the classifier in fp32 on whatever the
parameters hold; input dims divisible by 32. BatchNorm is not folded
into the convolutions. The parameters are kept in the compute dtype.

Training (``cli/train_segmenter.py``) follows the JAX trainer, which
differentiates the whole variables tree: the BatchNorm statistics are
trained as leaves. They stay buffers here; a caller that sets
``requires_grad`` on them gets Flax's explicit normalisation, through
which gradients reach them.

The state dict mirrors the Flax tree: ``encoder.layer1_0.conv1.weight``
is ``params/encoder/layer1_0/conv1/kernel`` (OIHW from HWIO),
``...bn1.weight/bias/running_mean/running_var`` are ``scale``/``bias``
and ``batch_stats/.../mean``/``var``; ``state_dict_from_flax`` does the
mapping, ``flax_tree_from_state_dict`` the inverse, and
``convert_torch_state_dict`` reads an smp-named state dict.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Flax's BatchNorm default, and the GroupNorm eps the Flax model sets
BN_EPS = 1e-5
GN_EPS = 1e-5
GN_GROUPS = 32
DROPOUT_RATE = 0.2


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class BatchNorm(nn.Module):
    """Inference BatchNorm on running statistics (Flax's
    ``use_running_average=True``): scale and bias are parameters, mean
    and var buffers. When the statistics require grad, the explicit form
    of Flax's ``_normalize``, ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias``, since ``F.batch_norm`` does not differentiate them."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not (self.running_mean.requires_grad or self.running_var.requires_grad):
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=BN_EPS,
            )
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return (x - self.running_mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, strides)
        self.bn1 = BatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features)
        if cin != features or strides != 1:
            self.downsample_conv = _conv(cin, features, 1, strides)
            self.downsample_bn = BatchNorm(features)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet18Encoder(nn.Module):
    STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, (features, strides) in enumerate(self.STAGES):
            setattr(self, f"layer{i + 1}_0", BasicBlock(cin, features, strides))
            setattr(self, f"layer{i + 1}_1", BasicBlock(features, features, 1))
            cin = features

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for i in range(len(self.STAGES)):
            x = getattr(self, f"layer{i + 1}_0")(x)
            x = getattr(self, f"layer{i + 1}_1")(x)
            feats.append(x)
        return feats  # c2 (1/4, 64) .. c5 (1/32, 512)


def _upsample(x, factor: int):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate`` and divide the kept ones by it. The mask is drawn with
    ``generator`` (on ``x``'s device; None: the default one)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Conv3x3GNReLU(nn.Module):
    def __init__(self, cin: int, features: int, upsample: bool = False):
        super().__init__()
        self.conv = _conv(cin, features, 3)
        self.gn = nn.GroupNorm(GN_GROUPS, features, eps=GN_EPS)
        self.upsample = upsample

    def forward(self, x):
        x = F.relu(self.gn(self.conv(x)))
        return _upsample(x, 2) if self.upsample else x


class SegmentationBlock(nn.Module):
    def __init__(self, cin: int, features: int, n_upsamples: int):
        super().__init__()
        for i in range(max(1, n_upsamples)):
            setattr(
                self,
                f"block{i}",
                Conv3x3GNReLU(cin if i == 0 else features, features, n_upsamples > 0),
            )
        self.n_blocks = max(1, n_upsamples)

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class FPNResNet18(nn.Module):
    """FPN segmentation head over a ResNet-18 encoder (pyramid 256,
    segmentation 128, sum merge, 4x bilinear upsampling). ``forward``
    takes (N, H, W, 3) and returns fp32 logits (N, H, W, num_classes).
    ``train=True`` applies the dropout, with masks drawn from
    ``generator``; as in Flax, ``Module.train()``/``eval()`` switch
    nothing."""

    def __init__(
        self, num_classes: int = 10, pyramid_channels: int = 256, segmentation_channels: int = 128
    ):
        super().__init__()
        self.encoder = ResNet18Encoder()
        for name, cin in (("p5", 512), ("p4", 256), ("p3", 128), ("p2", 64)):
            setattr(self, name, _conv(cin, pyramid_channels, 1, bias=True))
        for name, ups in (("s5", 3), ("s4", 2), ("s3", 1), ("s2", 0)):
            setattr(self, name, SegmentationBlock(pyramid_channels, segmentation_channels, ups))
        self.head = _conv(segmentation_channels, num_classes, 1, bias=True)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        h, w = x.shape[-3], x.shape[-2]
        if h % 32 or w % 32:
            raise ValueError(
                f"FPN input dims must be divisible by 32, got {h}x{w} "
                "(same constraint as the reference smp.FPN)"
            )
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        c2, c3, c4, c5 = self.encoder(x)
        p5 = self.p5(c5)
        p4 = self.p4(c4) + _upsample(p5, 2)
        p3 = self.p3(c3) + _upsample(p4, 2)
        p2 = self.p2(c2) + _upsample(p3, 2)
        x = self.s5(p5) + self.s4(p4) + self.s3(p3) + self.s2(p2)
        if train:
            x = dropout(x, DROPOUT_RATE, generator)
        # the classifier in fp32
        x = F.conv2d(x.float(), self.head.weight.float(), self.head.bias.float())
        x = F.interpolate(x, scale_factor=4, mode="bilinear", align_corners=True)
        return x.permute(0, 2, 3, 1)


def _hwio_to_oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _vector(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value))


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The ``FPNResNet18`` state dict of a Flax variables tree
    (``{"params": ..., "batch_stats": ...}`` with numpy leaves), in the
    tree's dtypes: conv kernels HWIO -> OIHW, norm ``scale`` -> weight,
    BatchNorm ``mean``/``var`` -> running statistics."""
    out: dict[str, torch.Tensor] = {}

    def walk(params, stats, prefix):
        for key, value in params.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, (stats or {}).get(key), name + ".")
            elif key == "kernel":
                out[f"{prefix}weight"] = _hwio_to_oihw(value)
            elif key == "scale":
                out[f"{prefix}weight"] = _vector(value)
            elif key == "bias":
                out[f"{prefix}bias"] = _vector(value)
            else:
                raise KeyError(f"unexpected parameter {name}")
        if stats is not None and "mean" in stats:
            out[f"{prefix}running_mean"] = _vector(stats["mean"])
            out[f"{prefix}running_var"] = _vector(stats["var"])

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return out


def flax_tree_from_state_dict(state_dict: dict) -> dict:
    """The Flax variables tree (numpy leaves) of an ``FPNResNet18`` state
    dict, the inverse of :func:`state_dict_from_flax`; bf16 tensors
    become fp32 arrays (numpy has no bfloat16)."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for name, t in state_dict.items():
        t = t.detach().cpu()
        value = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        *path, leaf = name.split(".")
        if leaf == "weight" and value.ndim == 4:
            put(params, (*path, "kernel"), np.ascontiguousarray(value.transpose(2, 3, 1, 0)))
        elif leaf == "weight":
            put(params, (*path, "scale"), value)
        elif leaf == "bias":
            put(params, (*path, "bias"), value)
        elif leaf == "running_mean":
            put(stats, (*path, "mean"), value)
        elif leaf == "running_var":
            put(stats, (*path, "var"), value)
    return {"params": params, "batch_stats": stats}


def convert_torch_state_dict(state_dict: dict) -> dict:
    """Map an smp FPN-ResNet18 state dict (numpy values) onto the Flax
    variables tree (numpy leaves), as the JAX package's
    ``convert_torch_state_dict`` does: OIHW -> HWIO, BatchNorm gamma/beta
    -> scale/bias, running statistics -> ``batch_stats``. Feed the result
    to :func:`state_dict_from_flax`."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(value)

    def conv(w):
        return np.transpose(np.asarray(w), (2, 3, 1, 0))

    def bn(flax_path, torch_prefix):
        put(params, flax_path + ("scale",), state_dict[torch_prefix + ".weight"])
        put(params, flax_path + ("bias",), state_dict[torch_prefix + ".bias"])
        put(stats, flax_path + ("mean",), state_dict[torch_prefix + ".running_mean"])
        put(stats, flax_path + ("var",), state_dict[torch_prefix + ".running_var"])

    enc = ("encoder",)
    put(params, enc + ("conv1", "kernel"), conv(state_dict["encoder.conv1.weight"]))
    bn(enc + ("bn1",), "encoder.bn1")
    for layer in range(1, 5):
        for block in range(2):
            fl = enc + (f"layer{layer}_{block}",)
            tp = f"encoder.layer{layer}.{block}"
            put(params, fl + ("conv1", "kernel"), conv(state_dict[f"{tp}.conv1.weight"]))
            bn(fl + ("bn1",), f"{tp}.bn1")
            put(params, fl + ("conv2", "kernel"), conv(state_dict[f"{tp}.conv2.weight"]))
            bn(fl + ("bn2",), f"{tp}.bn2")
            if f"{tp}.downsample.0.weight" in state_dict:
                put(
                    params,
                    fl + ("downsample_conv", "kernel"),
                    conv(state_dict[f"{tp}.downsample.0.weight"]),
                )
                bn(fl + ("downsample_bn",), f"{tp}.downsample.1")

    # decoder lateral convs (smp names: decoder.p5/p4/p3/p2)
    for p in ("p5", "p4", "p3", "p2"):
        key = f"decoder.{p}.weight"
        if key not in state_dict:  # p4..p2 are Conv in a Sequential in smp
            key = f"decoder.{p}.skip_conv.weight"
        put(params, (p, "kernel"), conv(state_dict[key]))
        put(params, (p, "bias"), state_dict[key.replace("weight", "bias")])

    # segmentation blocks: smp decoder.seg_blocks.{i}.block, i over p5..p2
    for i, name in enumerate(["s5", "s4", "s3", "s2"]):
        base = f"decoder.seg_blocks.{i}.block"
        j = 0
        while True:
            ck = f"{base}.{j}.block.0.weight"
            if ck not in state_dict:
                if j == 0 and f"{base}.block.0.weight" in state_dict:
                    put(params, (name, "block0", "conv", "kernel"), conv(state_dict[f"{base}.block.0.weight"]))
                    put(params, (name, "block0", "gn", "scale"), state_dict[f"{base}.block.1.weight"])
                    put(params, (name, "block0", "gn", "bias"), state_dict[f"{base}.block.1.bias"])
                break
            put(params, (name, f"block{j}", "conv", "kernel"), conv(state_dict[ck]))
            put(params, (name, f"block{j}", "gn", "scale"), state_dict[f"{base}.{j}.block.1.weight"])
            put(params, (name, f"block{j}", "gn", "bias"), state_dict[f"{base}.{j}.block.1.bias"])
            j += 1

    put(params, ("head", "kernel"), conv(state_dict["segmentation_head.0.weight"]))
    put(params, ("head", "bias"), state_dict["segmentation_head.0.bias"])
    return {"params": params, "batch_stats": stats}
