"""Swin Transformer backbone (Liu et al., ICCV 2021, arXiv:2103.14030) as
Mask2Former's ``D2SwinTransformer`` runs it (facebookresearch/Mask2Former
``mask2former/modeling/backbone/swin.py``), giving res2-res5 to the
pixel decoder.

Layer equations (the published code; Swin-L's widths in ``SwinConfig``):

- patch embedding: a 4x4 stride-4 convolution with bias to ``embed_dim``,
  then LayerNorm (``patch_norm``); no absolute position embedding;
- four stages of ``depths`` blocks, stage i of ``embed_dim 2^i`` channels
  and ``num_heads[i]`` heads of 32; each block ``x + attn(LN1(x))`` then
  ``x + MLP(LN2(x))``, the MLP ``fc1`` to ``mlp_ratio`` C, GELU (erf),
  ``fc2``; LayerNorm eps 1e-5; drop path an identity at inference;
- ``attn``: window attention over ``window_size`` x ``window_size``
  windows of the normed map padded with zeros to whole windows, in
  blocks of odd index over the map rolled by ``-window_size // 2``
  (shifted windows, with the published -100 mask between the rolled
  map's regions), q scaled by 32^-0.5, the relative position bias
  ``table[index]`` added to the scores; the qkv Linear with bias, the
  proj Linear (``ops/window_attention`` has the core's equations);
- patch merging after stages 1-3: ``x[0::2, 0::2]``, ``x[1::2, 0::2]``,
  ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated, LayerNorm(4C), a
  Linear to 2C with no bias;
- out-norms ``norm0``-``norm3``: LayerNorm of each stage's output before
  the merging, res2-res5.

Departures of form, none of the mathematics: the qkv and proj Linears
run on the real tokens only, where the published block runs them on
the padded windows (per-token maps whose padded outputs are cropped);
the padding, the roll, the partition and their reverses are index
arithmetic inside the window-attention kernel on the card; the maps
are (N, H, W, C) throughout, and res2-res5 are NCHW views of them
(``channels_last`` memory), as the pixel decoder takes its inputs.

The state dict's names are detectron2's (``backbone.`` in the
segmenter): ``patch_embed.proj``, ``patch_embed.norm``,
``layers.{i}.blocks.{j}.{norm1, attn.relative_position_bias_table,
attn.relative_position_index, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``, ``layers.{i}.downsample.{reduction, norm}``, ``norm{i}``, so
that the model zoo's Swin checkpoint loads by name. The relative
position index is a buffer of the state dict, as published; the kernel
computes it from coordinates and reads it not.

Spans: ``swin.stage1`` .. ``swin.stage4`` (d; stage 1 with the patch
embedding, stages 2-4 with the merging before them, each with its
out-norm) inside ``mask2former.backbone``, and ``swin.window_attention``
(d, one a block, the attention core).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from acmpc_tpu_torch.ops.window_attention import relative_position_index, window_attention
from acmpc_tpu_torch.utils.monitor import MONITOR

LN_EPS = 1e-5  # nn.LayerNorm's default, as published


class SwinConfig:
    """``D2SwinTransformer``'s shape under ``transformers``' ``SwinConfig``
    names, Swin-L's by default (Mask2Former's
    ``maskformer2_swin_large_IN21k_384_bs16_90k.yaml``); ``hidden_sizes``
    the four stages' widths (res2-res5)."""

    model_type = "swin"

    def __init__(self, embed_dim: int = 192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                 window_size: int = 12, mlp_ratio: float = 4.0, patch_size: int = 4):
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.mlp_ratio = mlp_ratio
        self.patch_size = patch_size
        self.hidden_sizes = tuple(embed_dim * 2 ** i for i in range(len(self.depths)))


def _layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.norm = _layer_norm(cfg.embed_dim)

    def forward(self, x):
        """(N, 3, H, W) -> (N, H / 4, W / 4, C)."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, shift: int):
        """The normed (N, H, W, C) map -> the attention's output, projected."""
        qkv = self.qkv(x)
        with MONITOR.device_span("swin.window_attention", x.device):
            out = window_attention(qkv, self.qkv.bias, self.relative_position_bias_table, self.heads, self.window,
                                   shift)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.shift = shift
        self.norm1 = _layer_norm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x), self.shift)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = _layer_norm(4 * dim)

    def forward(self, x):
        """(N, H, W, C) -> (N, H / 2, W / 2, 2C); H and W even."""
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio) for j in range(depth)
        )
        self.downsample = PatchMerging(dim) if merge else None


class SwinTransformer(nn.Module):
    """``D2SwinTransformer``: (N, 3, H, W) normalised frames, H and W
    divisible by 32 -> res2 .. res5, NCHW in ``channels_last`` memory."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.hidden_sizes[i], cfg.depths[i], cfg.num_heads[i], cfg.window_size, cfg.mlp_ratio,
                       i < n - 1)
            for i in range(n)
        )
        for i, c in enumerate(cfg.hidden_sizes):
            self.add_module(f"norm{i}", _layer_norm(c))

    def forward(self, x):
        out = []
        for i, layer in enumerate(self.layers):
            with MONITOR.device_span(f"swin.stage{i + 1}", x.device):
                x = self.patch_embed(x) if i == 0 else self.layers[i - 1].downsample(x)
                for block in layer.blocks:
                    x = block(x)
                out.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
        return out
