"""SegFormer semantic segmentation model as PyTorch modules: the Mix
Transformer (MiT) encoder and the all-MLP decoder.

Xie et al., *SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers*, NeurIPS 2021 (arXiv:2105.15203); the
B2 widths of NVlabs/SegFormer's ``segformer.b2`` configurations and of
``transformers``' ``SegformerConfig``. The JAX package has no
counterpart: the port's second segmenter, chosen by
``perception.architecture``.

Layer equations (mmseg's MiT, which the paper's code is):

- each of the four stages opens with an overlapping patch embedding, a
  convolution of kernel k, stride s and padding k // 2, then LayerNorm;
- each block is ``x = x + Attn(LN(x))``, then ``x = x + FFN(LN(x))``;
- Attn: Q = Linear(C -> C) of x; where the stage's reduction R > 1 the
  tokens, as (C, H, W), go through Conv(C -> C, kernel R, stride R) and
  LayerNorm; K and V are two Linear(C -> C) of those tokens; scaled
  dot-product attention over C / 64 heads of 64, then Linear(C -> C);
- FFN (Mix-FFN): Linear(C -> 4C), depthwise 3x3 convolution with bias
  over the (4C, H, W) tokens, exact GELU, Linear(4C -> C);
- each stage ends in LayerNorm;
- the head: each stage's output through Linear(C_i -> 768), resized
  bilinearly (``align_corners=False``) to stage 1's grid, the four
  concatenated deepest first, a 1x1 convolution (3072 -> 768, no bias),
  BatchNorm on running statistics, ReLU and a 1x1 convolution to the
  classes, at stage 1's grid (a quarter of the frame);
- :func:`to_frame`: those logits resized bilinearly to the frame.

Every LayerNorm takes eps 1e-6, as mmseg's MiT (``norm_cfg=dict(type=
'LN', eps=1e-6)``); BatchNorm eps 1e-5 (PyTorch's default, mmseg's
``SyncBN``). Inference only: dropout and drop-path are identities.

The model takes (N, H, W, 3) and returns (N, H / 4, W / 4, classes)
logits in the parameters' dtype, as ``transformers``' model returns
them before the caller resizes them (:func:`to_frame`); the frame is the
segmenter's uint8 divided by 255 (no ImageNet mean and deviation: the
segmenter's input convention is the FPN's). H and W must divide by 32.
Inside, the feature maps are NCHW in ``channels_last`` memory, so that
tokens (N, H * W, C) and maps are views of one buffer and no transpose
is copied. Attention goes through ``F.scaled_dot_product_attention``; on
the card through the backend ``ATTENTION_BACKENDS`` pins. The head's
resizes and concatenation are ``ops/segformer_resample.py``: on the card
one kernel, bit-equal to ``F.interpolate`` and ``torch.cat``.

The state dict's names are those of ``transformers``'
``SegformerForSemanticSegmentation`` (``segformer.encoder.block.0.0.
attention.self.query.weight``, ``decode_head.linear_fuse.weight``...),
so a published state dict loads by name. :func:`init_state_dict` draws
the published initialisation from a seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from acmpc_tpu_torch.ops.segformer_resample import segformer_resample
from acmpc_tpu_torch.utils.monitor import MONITOR

LN_EPS = 1e-6


class SegformerConfig:
    """The published B2 shape (``transformers``' ``SegformerConfig``
    names); ``num_labels`` is the agent's 10 classes."""

    hidden_sizes = (64, 128, 320, 512)
    depths = (3, 4, 6, 3)
    num_attention_heads = (1, 2, 5, 8)
    sr_ratios = (8, 4, 2, 1)
    patch_sizes = (7, 3, 3, 3)
    strides = (4, 2, 2, 2)
    mlp_ratios = (4, 4, 4, 4)
    decoder_hidden_size = 768
    num_channels = 3

    def __init__(self, num_labels: int = 10, depths: tuple | None = None):
        self.num_labels = num_labels
        if depths is not None:
            self.depths = tuple(depths)


# the attention backend on the card: cuDNN's fused attention, the fastest
# of PyTorch's at B2's four stage shapes at 1280x736 in bf16 on an H100
# (0.47 ms a frame against FlashAttention-2's 0.56; PERF.md)
ATTENTION_BACKENDS = [SDPBackend.CUDNN_ATTENTION]


def _attention(q, k, v):
    """Scaled dot-product attention, on the card through the pinned
    backend (``ATTENTION_BACKENDS``)."""
    if q.is_cuda:
        with sdpa_kernel(ATTENTION_BACKENDS):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) in channels_last memory -> (N, H * W, C), a view."""
    return x.flatten(2).transpose(1, 2)


def _map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H * W, C) -> (N, C, H, W) in channels_last memory, a view."""
    return x.unflatten(1, (h, w)).permute(0, 3, 1, 2)


class OverlapPatchEmbeddings(nn.Module):
    def __init__(self, patch_size: int, stride: int, cin: int, hidden: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, hidden, patch_size, stride=stride, padding=patch_size // 2)
        self.layer_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        h, w = x.shape[-2:]
        return self.layer_norm(_tokens(x)), h, w


class EfficientSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = nn.Conv2d(hidden, hidden, sr_ratio, stride=sr_ratio)
            self.layer_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def _heads(self, x):
        return x.unflatten(-1, (self.heads, -1)).transpose(1, 2)  # (N, heads, T, 64)

    def forward(self, x, h: int, w: int):
        q = self._heads(self.query(x))
        if self.sr_ratio > 1:
            x = self.sr(_map(x, h, w))
            x = self.layer_norm(_tokens(x))
        k, v = self._heads(self.key(x)), self._heads(self.value(x))
        with MONITOR.device_span("segformer.attention", q.device):
            out = _attention(q, k, v)
        return out.transpose(1, 2).flatten(2)


class SelfOutput(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)

    def forward(self, x):
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int):
        super().__init__()
        self.self = EfficientSelfAttention(hidden, heads, sr_ratio)
        self.output = SelfOutput(hidden)

    def forward(self, x, h: int, w: int):
        return self.output(self.self(x, h, w))


class DWConv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.dwconv = nn.Conv2d(channels, channels, 3, padding=1, groups=channels)

    def forward(self, x, h: int, w: int):
        return _tokens(self.dwconv(_map(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, hidden: int, ratio: int):
        super().__init__()
        self.dense1 = nn.Linear(hidden, hidden * ratio)
        self.dwconv = DWConv(hidden * ratio)
        self.dense2 = nn.Linear(hidden * ratio, hidden)

    def forward(self, x, h: int, w: int):
        return self.dense2(F.gelu(self.dwconv(self.dense1(x), h, w)))


class Layer(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attention = Attention(hidden, heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.mlp = MixFFN(hidden, mlp_ratio)

    def forward(self, x, h: int, w: int):
        x = x + self.attention(self.layer_norm_1(x), h, w)
        return x + self.mlp(self.layer_norm_2(x), h, w)


class Encoder(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        cins = (cfg.num_channels, *cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbeddings(p, s, cin, c)
            for p, s, cin, c in zip(cfg.patch_sizes, cfg.strides, cins, cfg.hidden_sizes)
        )
        self.block = nn.ModuleList(
            nn.ModuleList(Layer(c, heads, sr, ratio) for _ in range(depth))
            for c, heads, sr, ratio, depth in zip(
                cfg.hidden_sizes, cfg.num_attention_heads, cfg.sr_ratios, cfg.mlp_ratios, cfg.depths
            )
        )
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in cfg.hidden_sizes)

    def forward(self, x):
        """(N, 3, H, W) -> each stage's output as (N, C_i, H_i, W_i)."""
        out = []
        for i, (embed, blocks, norm) in enumerate(zip(self.patch_embeddings, self.block, self.layer_norm)):
            with MONITOR.device_span(f"segformer.stage{i + 1}", x.device):
                t, h, w = embed(x)
                for layer in blocks:
                    t = layer(t, h, w)
                x = _map(norm(t), h, w)
            out.append(x)
        return out


class SegformerModel(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        self.encoder = Encoder(cfg)

    def forward(self, x):
        return self.encoder(x)


class MLP(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(cin, hidden)

    def forward(self, x):
        return self.proj(x)


class DecodeHead(nn.Module):
    def __init__(self, cfg: SegformerConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList(MLP(c, d) for c in cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(d * len(cfg.hidden_sizes), d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d)
        self.classifier = nn.Conv2d(d, cfg.num_labels, 1)

    def forward(self, feats):
        parts = [_map(mlp(_tokens(x)), *x.shape[-2:]) for x, mlp in zip(feats, self.linear_c)]
        # resized to stage 1's grid and concatenated deepest first, as published
        x = segformer_resample(parts, feats[0].shape[-2:])
        x = F.relu(self.batch_norm(self.linear_fuse(x)))
        return self.classifier(x)


class SegformerForSemanticSegmentation(nn.Module):
    """SegFormer (encoder and all-MLP head). ``forward`` takes
    (N, H, W, 3) and returns the logits (N, H / 4, W / 4, num_labels) at
    stage 1's grid, in the parameters' dtype."""

    def __init__(self, cfg: SegformerConfig | None = None):
        super().__init__()
        self.config = cfg = cfg or SegformerConfig()
        self.segformer = SegformerModel(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        if h % 32 or w % 32:
            raise ValueError(f"SegFormer input dims must be divisible by 32, got {h}x{w}")
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.segformer(x)
        with MONITOR.device_span("segformer.decode", x.device):
            x = self.decode_head(feats)
        return x.permute(0, 2, 3, 1)


def to_frame(logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The model's (N, h', w', C) logits resized bilinearly
    (``align_corners=False``) to float32 (N, h, w, C)."""
    x = F.interpolate(logits.permute(0, 3, 1, 2).float(), size=(h, w), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def init_state_dict(seed: int, cfg: SegformerConfig | None = None) -> dict[str, torch.Tensor]:
    """The published initialisation (mmseg's MiT ``init_weights``) drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed``, in
    float32, in the state dict's order: Linear weights a normal of
    deviation 0.02 truncated at +-2 (timm's ``trunc_normal_``), biases
    0; convolution weights a normal of deviation sqrt(2 / fan_out),
    fan_out = k * k * out_channels / groups, biases 0; LayerNorm and
    BatchNorm weights 1, biases 0; BatchNorm statistics 0 and 1."""
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    model = SegformerForSemanticSegmentation(cfg)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            nn.init.trunc_normal_(module.weight, std=0.02, a=-2.0, b=2.0, generator=gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv2d):
            k0, k1 = module.kernel_size
            fan_out = k0 * k1 * module.out_channels // module.groups
            nn.init.normal_(module.weight, std=math.sqrt(2.0 / fan_out), generator=gen)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
    return model.state_dict()
