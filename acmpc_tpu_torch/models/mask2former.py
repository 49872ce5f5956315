"""Mask2Former semantic segmentation model as PyTorch modules: a
ResNet-50 or Swin backbone, the multi-scale deformable-attention pixel
decoder and the masked-attention transformer decoder, with semantic
inference.

Cheng et al., *Masked-attention Mask Transformer for Universal Image
Segmentation*, CVPR 2022 (arXiv:2112.01527); the widths and depths of
facebookresearch/Mask2Former's ``configs/cityscapes/semantic-
segmentation/maskformer2_R50_bs16_90k.yaml`` (over ``Base-Cityscapes-
SemanticSegmentation.yaml``), and with ``swin/maskformer2_swin_large_
IN21k_384_bs16_90k.yaml``'s Swin-L backbone (``models/swin.py``) in
place of the ResNet, the rest unchanged. The JAX package has no
counterpart: the port's own segmenters, chosen by
``perception.architecture``.

Layer equations (the paper's code, detectron2's modules):

- backbone (``Mask2FormerConfig.backbone``): ResNet-50 (below) or
  Swin-L (``models/swin.py``), its four stages' widths
  (``hidden_sizes``) the pixel decoder's inputs;
- ResNet-50: a 7x7 stride-2 stem (64), max pooling 3x3 stride
  2, then bottleneck stages res2-res5 of 3/4/6/3 blocks, widths
  256/512/1024/2048 (inner 64/128/256/512), the stride in the 3x3
  (``STRIDE_IN_1X1: False``), a 1x1 shortcut where the width or stride
  changes; every norm a frozen BatchNorm on running statistics, ReLU
  after each norm but the third and after the sum;
- pixel decoder (``MSDeformAttnPixelDecoder``): res5, res4, res3 (in that
  order, coarsest first) through 1x1 convolutions with bias and
  GroupNorm(32) to 256; the sine position embedding (128 features a
  coordinate, normalised, 2 pi, temperature 10,000) plus a learned level
  embedding; 6 post-norm encoder layers, each multi-scale deformable
  attention (8 heads of 32, 3 levels, 4 points: ``ops/ms_deform_attn``)
  of the tokens plus position as queries over the tokens as values,
  then a ReLU FFN of 1,024; the encoder's output split back into the
  three maps; a 1/4-scale level from res2: a lateral 1x1 convolution
  and GroupNorm, plus the 1/8 map resized bilinearly (corners not
  aligned), through a 3x3 convolution, GroupNorm and ReLU; the mask
  features a 1x1 convolution with bias of it;
- transformer decoder (``MultiScaleMaskedTransformerDecoder``): 100
  learned queries (features and positions) of 256, a prediction on them,
  then 9 layers (``DEC_LAYERS`` 10 counts the first prediction), layer
  i over level i mod 3 (1/32, 1/16, 1/8, the level embedding added to
  the keys' tokens, the sine embedding to the keys): masked
  cross-attention, self-attention, FFN of 2,048, each post-norm with 8
  heads, each followed by a prediction;
- a prediction: LayerNorm, a class linear to the classes plus
  no-object, a 3-layer MLP (ReLU between) to the mask embedding, its
  product with the mask features (the mask logits at 1/4); the next
  layer's attention mask is those logits resized bilinearly to the next
  level's grid and ``sigmoid < 0.5`` (a key a query may not attend to);
  a query whose every key is masked attends to all of them
  (:func:`release`);
- semantic inference (:func:`semantic_scores`): the final mask logits
  resized bilinearly to the frame, ``softmax(class)[:, :-1]^T .
  sigmoid(mask)``.

Departures from the published description, all of them of arithmetic
or of form, none of the mathematics:

- the model computes in the parameters' dtype (bf16 on the card), where
  the paper's code runs the deformable encoder in float32; the sampling
  locations and the attention's softmax are float32 inside the kernel;
- the frame's channels are taken in the order the camera hands them, and
  normalised in float32 by the published RGB mean and deviation (0-255);
- the published in-place release of fully masked rows,
  ``attn_mask[torch.where(attn_mask.sum(-1) == L)] = False``, reads the
  host; :func:`release` is its elementwise form, so that the forward
  stays on the card inside a CUDA graph;
- the last layer's prediction makes no attention mask (no layer reads
  it), and the masks are not repeated over the heads (one (queries,
  keys) mask broadcast to every head);
- inference only: dropout is an identity; 10 classes (the agent's) where
  Cityscapes has 19.

The model takes (N, H, W, 3) frames (uint8 or float, 0-255) and returns
the flat tuple ``(class_logits (N, 100, 11), mask_logits (N, 100, H / 4,
W / 4), memory, *masks)``: ``memory`` the deformable encoder's output
tokens (N, S, 256), the 1/32, 1/16 and 1/8 maps' in turn, and ``masks``
the 9 boolean attention masks (N, 100, h_i * w_i) as ``sigmoid < 0.5``
gives them, before the release, in the order of the layers that read
them; with a Swin backbone, its res2-res5 follow the masks (the
benchmark's judge reads them). Inside, the feature maps are NCHW in
``channels_last`` memory, so that a map's tokens (N, H * W, C) are a
view. H and W must divide by 32. The attention goes through
``F.scaled_dot_product_attention``, on the card through the backends
``ATTENTION_BACKENDS`` pins.

The state dict's names are detectron2's (``backbone.res2.0.conv1.weight``,
``backbone.res2.0.conv1.norm.running_mean``, ``sem_seg_head.pixel_decoder.
transformer.encoder.layers.0.self_attn.sampling_offsets.weight``,
``sem_seg_head.predictor.transformer_cross_attention_layers.0.
multihead_attn.in_proj_weight``...), so that the model zoo's Cityscapes
R50 and Swin-L checkpoints load by name. The frozen BatchNorm and the
convolution helpers are the FPN's (``models/fpn_resnet18.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from acmpc_tpu_torch.models.fpn_resnet18 import GN_EPS, GN_GROUPS, BatchNorm, _conv
from acmpc_tpu_torch.models.swin import SwinConfig, SwinTransformer
from acmpc_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from acmpc_tpu_torch.utils.monitor import MONITOR

# detectron2's PIXEL_MEAN and PIXEL_STD (RGB, 0-255)
PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
LN_EPS = 1e-5  # nn.LayerNorm's default, as published


class Mask2FormerConfig:
    """The published R50 Cityscapes shape, under ``transformers``'
    ``Mask2FormerConfig`` names (the backbone's as ``ResNetConfig``'s);
    ``num_labels`` is the agent's 10 classes. ``decoder_layers`` counts
    the learned queries' first prediction, as ``DEC_LAYERS`` does.
    ``backbone_config`` a ``SwinConfig`` puts that Swin in place of the
    ResNet: ``backbone`` names the backbone's kind, ``hidden_sizes`` its
    four stages' widths, which the pixel decoder reads."""

    backbone = "resnet"
    backbone_config: SwinConfig | None = None
    embedding_size = 64
    hidden_sizes = (256, 512, 1024, 2048)
    depths = (3, 4, 6, 3)
    feature_size = 256
    mask_feature_size = 256
    hidden_dim = 256
    encoder_feedforward_dim = 1024
    encoder_layers = 6
    decoder_layers = 10
    num_attention_heads = 8
    dim_feedforward = 2048
    num_queries = 100
    num_feature_levels = 3
    encoder_n_points = 4

    def __init__(self, num_labels: int = 10, encoder_layers: int | None = None,
                 decoder_layers: int | None = None, backbone_config: SwinConfig | None = None):
        self.num_labels = num_labels
        if encoder_layers is not None:
            self.encoder_layers = encoder_layers
        if decoder_layers is not None:
            self.decoder_layers = decoder_layers
        if backbone_config is not None:
            self.backbone, self.backbone_config = backbone_config.model_type, backbone_config
            self.hidden_sizes = backbone_config.hidden_sizes


# the decoder's attention backend on the card: cuDNN's fused attention,
# which takes the boolean mask (FlashAttention takes none), the fastest
# at the three key lengths in bf16 on an H100 (100 queries, 8 heads of
# 32: 920, 3,680 and 14,720 keys in 0.082, 0.077 and 0.224 ms against
# the memory-efficient kernel's 0.081, 0.200 and 0.765; PERF.md)
ATTENTION_BACKENDS = [SDPBackend.CUDNN_ATTENTION]


def _attention(q, k, v, mask=None):
    """Scaled dot-product attention (``mask``: True where a query may
    attend), on the card through the pinned backends."""
    if q.is_cuda:
        with sdpa_kernel(ATTENTION_BACKENDS):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) in channels_last memory -> (N, H * W, C), a view."""
    return x.flatten(2).transpose(1, 2)


def _map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H * W, C) -> (N, C, H, W) in channels_last memory, a view."""
    return x.unflatten(1, (h, w)).permute(0, 3, 1, 2)


def _conv_norm(cin: int, cout: int, k: int, stride: int = 1, norm: nn.Module | None = None) -> nn.Conv2d:
    """detectron2's ``Conv2d`` with its ``norm``: the FPN's convolution
    (no bias) carrying a frozen BatchNorm, or ``norm``."""
    conv = _conv(cin, cout, k, stride)
    conv.norm = norm if norm is not None else BatchNorm(cout)
    return conv


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, c, eps=GN_EPS)


def _cn(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv.norm(conv(x))


def position_embedding(h: int, w: int, feats: int, device, dtype=torch.float32) -> torch.Tensor:
    """The sine position embedding (``PositionEmbeddingSine``, normalised)
    of an h x w map as (h * w, 2 * feats) tokens: y's features, then x's,
    each sin and cos interleaved; computed in float32."""
    ones = torch.ones((1, h, w), dtype=torch.float32, device=device)
    y = ones.cumsum(1)
    x = ones.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    dim_t = torch.arange(feats, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / feats)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=4).flatten(3)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=4).flatten(3)
    return torch.cat((py, px), dim=3)[0].flatten(0, 1).to(dtype)


def release(blocked: torch.Tensor) -> torch.Tensor:
    """The keys each query may attend to, from the blocked ones (True: may
    not): a query whose every key is blocked attends to all of them, the
    published ``attn_mask[torch.where(attn_mask.sum(-1) == L)] = False``
    as an elementwise operation (no host read)."""
    return ~blocked | blocked.all(dim=-1, keepdim=True)


# -- backbone --------------------------------------------------------------


class Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = _conv_norm(3, width, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(_cn(self.conv1, x)), 3, stride=2, padding=1)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, inner: int, cout: int, stride: int):
        super().__init__()
        self.shortcut = _conv_norm(cin, cout, 1, stride) if cin != cout or stride != 1 else None
        self.conv1 = _conv_norm(cin, inner, 1)
        self.conv2 = _conv_norm(inner, inner, 3, stride)
        self.conv3 = _conv_norm(inner, cout, 1)

    def forward(self, x):
        y = F.relu(_cn(self.conv1, x))
        y = F.relu(_cn(self.conv2, y))
        y = _cn(self.conv3, y)
        return F.relu(y + (_cn(self.shortcut, x) if self.shortcut is not None else x))


class ResNet(nn.Module):
    """``res2`` .. ``res5`` as detectron2 names them."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        self.stem = Stem(cfg.embedding_size)
        cin = cfg.embedding_size
        for i, (cout, depth) in enumerate(zip(cfg.hidden_sizes, cfg.depths)):
            inner = cout // 4
            blocks = [Bottleneck(cin if j == 0 else cout, inner, cout, 2 if (i > 0 and j == 0) else 1)
                      for j in range(depth)]
            self.add_module(f"res{i + 2}", nn.Sequential(*blocks))
            cin = cout

    def forward(self, x):
        x = self.stem(x)
        out = []
        for i in range(4):
            x = getattr(self, f"res{i + 2}")(x)
            out.append(x)
        return out  # res2 (1/4) .. res5 (1/32)


# -- pixel decoder ---------------------------------------------------------


class MSDeformAttn(nn.Module):
    def __init__(self, d: int, heads: int, levels: int, points: int):
        super().__init__()
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, src, shapes):
        value = self.value_proj(src)
        out = ms_deform_attn(value, self.sampling_offsets(query), self.attention_weights(query), shapes)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, ffn: int, heads: int, levels: int, points: int):
        super().__init__()
        self.self_attn = MSDeformAttn(d, heads, levels, points)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, src, pos, shapes):
        with MONITOR.device_span("mask2former.deform_attn", src.device):
            src = self.norm1(src + self.self_attn(src + pos, src, shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class Encoder(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(cfg.feature_size, cfg.encoder_feedforward_dim, cfg.num_attention_heads,
                         cfg.num_feature_levels, cfg.encoder_n_points)
            for _ in range(cfg.encoder_layers)
        )


class DeformableTransformer(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, cfg.feature_size))
        self.encoder = Encoder(cfg)

    def forward(self, srcs):
        """The maps (coarsest first) -> the encoder's output tokens (N, S,
        C) and, as views of them, its output maps."""
        shapes = [tuple(s.shape[-2:]) for s in srcs]
        feats = self.level_embed.shape[-1] // 2
        src = torch.cat([_tokens(s) for s in srcs], dim=1)
        pos = torch.cat([position_embedding(h, w, feats, src.device) + self.level_embed[i].float()
                         for i, (h, w) in enumerate(shapes)]).to(src.dtype)[None]
        for layer in self.encoder.layers:
            src = layer(src, pos, shapes)
        out, start = [], 0
        for h, w in shapes:
            out.append(_map(src[:, start:start + h * w], h, w))
            start += h * w
        return src, out


class PixelDecoder(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d = cfg.feature_size
        # res5, res4, res3: coarsest first
        self.input_proj = nn.ModuleList(
            nn.Sequential(_conv(c, d, 1, bias=True), _group_norm(d))
            for c in cfg.hidden_sizes[1:][::-1]
        )
        self.transformer = DeformableTransformer(cfg)
        self.adapter_1 = _conv_norm(cfg.hidden_sizes[0], d, 1, norm=_group_norm(d))
        self.layer_1 = _conv_norm(d, d, 3, norm=_group_norm(d))
        self.mask_features = _conv(d, cfg.mask_feature_size, 1, bias=True)

    def forward(self, feats):
        """The backbone's res2-res5 -> (mask features at 1/4, the
        encoder's output tokens, its maps at 1/32, 1/16, 1/8)."""
        srcs = [proj(x) for proj, x in zip(self.input_proj, feats[1:][::-1])]
        memory, out = self.transformer(srcs)
        lateral = _cn(self.adapter_1, feats[0])
        y = lateral + F.interpolate(out[-1], size=lateral.shape[-2:], mode="bilinear", align_corners=False)
        y = F.relu(_cn(self.layer_1, y))
        return self.mask_features(y), memory, out


# -- transformer decoder ---------------------------------------------------


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (a packed input projection),
    computed through scaled dot-product attention."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def _heads(self, x):
        return x.unflatten(-1, (self.heads, -1)).transpose(1, 2)  # (N, heads, T, d / heads)

    def forward(self, q, k, v, mask=None):
        w, b = self.in_proj_weight.chunk(3), self.in_proj_bias.chunk(3)
        q, k, v = (self._heads(F.linear(x, wi, bi)) for x, wi, bi in zip((q, k, v), w, b))
        out = _attention(q, k, v, None if mask is None else mask[:, None])
        return self.out_proj(out.transpose(1, 2).flatten(2))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d, heads)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, memory, allowed, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory, allowed))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, heads)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MLP(nn.Module):
    def __init__(self, d: int, out: int, n: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(d, d if i < n - 1 else out) for i in range(n))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class Predictor(nn.Module):
    """``MultiScaleMaskedTransformerDecoder`` (its input projections are
    identities at these widths and hold no parameters)."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d, heads, n = cfg.hidden_dim, cfg.num_attention_heads, cfg.decoder_layers - 1
        self.levels = cfg.num_feature_levels
        self.transformer_self_attention_layers = nn.ModuleList(SelfAttentionLayer(d, heads) for _ in range(n))
        self.transformer_cross_attention_layers = nn.ModuleList(CrossAttentionLayer(d, heads) for _ in range(n))
        self.transformer_ffn_layers = nn.ModuleList(FFNLayer(d, cfg.dim_feedforward) for _ in range(n))
        self.decoder_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.query_feat = nn.Embedding(cfg.num_queries, d)
        self.query_embed = nn.Embedding(cfg.num_queries, d)
        self.level_embed = nn.Embedding(self.levels, d)
        self.class_embed = nn.Linear(d, cfg.num_labels + 1)
        self.mask_embed = MLP(d, cfg.mask_feature_size, 3)

    def _predict(self, output, mask_features, size):
        """(class logits, mask logits at 1/4, the blocked keys at ``size``
        (None: no mask))."""
        x = self.decoder_norm(output)
        cls = self.class_embed(x)
        h, w = mask_features.shape[-2:]
        mask = torch.matmul(self.mask_embed(x), _tokens(mask_features).transpose(1, 2)).unflatten(2, (h, w))
        if size is None:
            return cls, mask, None
        attn = F.interpolate(mask, size=size, mode="bilinear", align_corners=False)
        return cls, mask, attn.float().sigmoid().flatten(2) < 0.5

    def forward(self, feats, mask_features):
        n_layers = len(self.transformer_cross_attention_layers)
        d = self.query_feat.weight.shape[-1]
        sizes = [tuple(x.shape[-2:]) for x in feats]
        src = [_tokens(x) + self.level_embed.weight[i] for i, x in enumerate(feats)]
        pos = [position_embedding(h, w, d // 2, x.device, x.dtype)[None] for (h, w), x in zip(sizes, feats)]
        query_pos = self.query_embed.weight[None]
        output = self.query_feat.weight[None]
        cls, mask, blocked = self._predict(output, mask_features, sizes[0])
        masks = []
        for i in range(n_layers):
            level = i % self.levels
            masks.append(blocked)
            with MONITOR.device_span("mask2former.masked_attention", output.device):
                output = self.transformer_cross_attention_layers[i](output, src[level], release(blocked),
                                                                    pos[level], query_pos)
            output = self.transformer_self_attention_layers[i](output, query_pos)
            output = self.transformer_ffn_layers[i](output)
            last = i == n_layers - 1
            cls, mask, blocked = self._predict(output, mask_features, None if last else sizes[(i + 1) % self.levels])
        return (cls, mask, *masks)


class SemSegHead(nn.Module):
    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        self.pixel_decoder = PixelDecoder(cfg)
        self.predictor = Predictor(cfg)


class Mask2Former(nn.Module):
    """Mask2Former (backbone, pixel decoder, transformer decoder).
    ``forward`` takes (N, H, W, 3) frames (0-255) and returns (class
    logits, mask logits at 1/4, the encoder's output tokens, *the
    attention masks), then with a Swin backbone its res2-res5, in the
    parameters' dtype; :func:`semantic_scores` turns the first two into
    per-class scores at the frame."""

    def __init__(self, cfg: Mask2FormerConfig | None = None):
        super().__init__()
        self.config = cfg = cfg or Mask2FormerConfig()
        self.backbone = SwinTransformer(cfg.backbone_config) if cfg.backbone == "swin" else ResNet(cfg)
        self.sem_seg_head = SemSegHead(cfg)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        if h % 32 or w % 32:
            raise ValueError(f"Mask2Former input dims must be divisible by 32, got {h}x{w}")
        dtype = next(self.parameters()).dtype
        x = x.float()
        x = torch.cat([(x[..., c:c + 1] - m) / s for c, (m, s) in enumerate(zip(PIXEL_MEAN, PIXEL_STD))], dim=-1)
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        with MONITOR.device_span("mask2former.backbone", x.device):
            feats = self.backbone(x)
        with MONITOR.device_span("mask2former.pixel_decoder", x.device):
            mask_features, memory, maps = self.sem_seg_head.pixel_decoder(feats)
        with MONITOR.device_span("mask2former.decoder", x.device):
            cls, mask, *masks = self.sem_seg_head.predictor(maps, mask_features)
        if self.config.backbone == "swin":
            return (cls, mask, memory, *masks, *feats)
        return (cls, mask, memory, *masks)


def semantic_scores(class_logits: torch.Tensor, mask_logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Semantic inference (``MaskFormer.semantic_inference``): (N, Q, K + 1)
    class logits and (N, Q, h', w') mask logits -> (N, K, h, w) scores,
    ``softmax(class)[..., :-1]^T . sigmoid(mask)`` with the masks resized
    bilinearly (corners not aligned) to (h, w) first; the softmax in
    float32, the product in the masks' dtype with float32 sums."""
    with MONITOR.device_span("mask2former.semantic", mask_logits.device):
        probs = torch.softmax(class_logits.float(), dim=-1)[..., :-1]
        masks = F.interpolate(mask_logits, size=(h, w), mode="bilinear", align_corners=False).sigmoid_()
        scores = torch.bmm(probs.transpose(1, 2).to(masks.dtype), masks.flatten(2))
        return scores.unflatten(2, (h, w))
