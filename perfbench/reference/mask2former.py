"""Plain reference of Mask2Former (Cheng et al., CVPR 2022,
arXiv:2112.01527) with a ResNet-50 backbone, as functional PyTorch in
float32, on a state dict under detectron2's names (facebookresearch/
Mask2Former's ``maskformer2_R50_bs16_90k.yaml``), with the shape given as
a dict under ``transformers``' ``Mask2FormerConfig`` names.

The forward as published:

- backbone: the 7x7 stride-2 stem, max pooling, bottleneck stages of
  3/4/6/3 blocks (widths 256-2048, the stride in the 3x3), frozen
  BatchNorm on running statistics (eps 1e-5);
- pixel decoder: res5, res4, res3 (coarsest first) through a 1x1
  convolution and GroupNorm(32); the sine position embedding plus the
  level embedding; 6 post-norm deformable encoder layers (8 heads, 3
  levels, 4 points; the sampling as Deformable DETR's
  ``ms_deform_attn_core_pytorch``: ``F.grid_sample`` a level, bilinear,
  zero padding, corners not aligned, then the weighted sum), a ReLU FFN;
  a 1/4 level from res2 (lateral 1x1 + GroupNorm, plus the 1/8 map
  resized bilinearly, 3x3 + GroupNorm + ReLU) and the mask features'
  1x1 convolution;
- transformer decoder: 100 queries, a prediction, then 9 layers of
  masked cross-attention (level i mod 3: 1/32, 1/16, 1/8), self-attention
  and FFN, each post-norm, each followed by a prediction (LayerNorm, the
  class linear, the 3-layer mask MLP, its product with the mask
  features); the next layer's mask is the prediction's logits resized
  bilinearly to the next level and ``sigmoid < 0.5``, with the published
  in-place release of a row that masks every key; the attention
  softmax(Q K^T / sqrt(32)) V per head, in blocks of ``QUERY_BLOCK``
  queries (one block at 100 queries);
- semantic inference (``semantic``): the final mask logits resized
  bilinearly to the frame, ``softmax(class)[:, :-1]^T . sigmoid(mask)``.

Teacher forcing: ``forward(image, masks)`` takes the program's own
attention masks, layer by layer, in place of its own (a bit that the
program's rounding flips at ``sigmoid = 0.5`` would otherwise send the
two decoders over different keys, and the comparison would measure the
threshold, not the arithmetic); it still reports the logits its own
threshold reads (``attn_logits``), for the bits to be compared.

Departures from the published description: the frame's channels in the
order the camera hands them, normalised by the published RGB mean and
deviation; the classes the agent's 10, not Cityscapes' 19; dropout an
identity (inference).

It computes in float32, with TF32 off while it runs. ``fp8=True`` is the
control, one precision below the bfloat16 the configuration states:
every linear's and convolution's input and weight, and the decoder's Q,
K and V, rounded to float8 e4m3 with one scale per tensor (as
``reference/fpn.py`` rounds its convolutions).

Weights for the benchmark are drawn here (``random_state``: every
parameter and statistic non-trivial), and ``fit_heads`` then sets a few
rows of the mask features, the mask MLP and the class linear so that
the output segments the asphalt of a few frames (its docstring says
how).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.fpn import _fp8
from perfbench.reference.segformer import _exact

BN_EPS = GN_EPS = LN_EPS = 1e-5
GN_GROUPS = 32
QUERY_BLOCK = 8192
PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
# fit_heads: the asphalt score of the mask features' channel 0 is
# +-LOGIT_SCALE on a 4x4 block all asphalt or all not
LOGIT_SCALE = 4.0

SHAPE_KEYS = ("backbone_config", "feature_size", "mask_feature_size", "hidden_dim", "encoder_feedforward_dim",
              "encoder_layers", "decoder_layers", "num_attention_heads", "dim_feedforward", "num_queries",
              "num_feature_levels", "encoder_n_points", "num_labels")
PD = "sem_seg_head.pixel_decoder"
PR = "sem_seg_head.predictor"


class Mask2Former:
    def __init__(self, state: dict, shape: dict, device, fp8: bool = False):
        self.p = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32) for k, v in state.items()}
        self.shape = {k: shape[k] for k in SHAPE_KEYS}
        self.fp8 = fp8
        self.device = device

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.fp8 else t

    def linear(self, x, name, weight=None, bias=None):
        w = self.p[f"{name}.weight"] if weight is None else weight
        b = self.p.get(f"{name}.bias") if weight is None else bias
        return F.linear(self._q(x), self._q(w), b)

    def conv(self, x, name, stride=1, padding=0):
        return F.conv2d(self._q(x), self._q(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"),
                        stride=stride, padding=padding)

    def bn(self, x, name):
        inv = torch.rsqrt(self.p[f"{name}.running_var"] + BN_EPS) * self.p[f"{name}.weight"]
        return (x - self.p[f"{name}.running_mean"][:, None, None]) * inv[:, None, None] \
            + self.p[f"{name}.bias"][:, None, None]

    def gn(self, x, name):
        return F.group_norm(x, GN_GROUPS, self.p[f"{name}.weight"], self.p[f"{name}.bias"], GN_EPS)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"], LN_EPS)

    # -- backbone ----------------------------------------------------------

    def backbone(self, x):
        """(1, 3, H, W) normalised -> res2 .. res5."""
        x = F.relu(self.bn(self.conv(x, "backbone.stem.conv1", 2, 3), "backbone.stem.conv1.norm"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        out = []
        b = self.shape["backbone_config"]
        for i, depth in enumerate(b["depths"]):
            for j in range(depth):
                n = f"backbone.res{i + 2}.{j}"
                stride = 2 if (i > 0 and j == 0) else 1
                y = F.relu(self.bn(self.conv(x, f"{n}.conv1"), f"{n}.conv1.norm"))
                y = F.relu(self.bn(self.conv(y, f"{n}.conv2", stride, 1), f"{n}.conv2.norm"))
                y = self.bn(self.conv(y, f"{n}.conv3"), f"{n}.conv3.norm")
                if f"{n}.shortcut.weight" in self.p:
                    x = self.bn(self.conv(x, f"{n}.shortcut", stride), f"{n}.shortcut.norm")
                x = F.relu(y + x)
            out.append(x)
        return out

    # -- pixel decoder -----------------------------------------------------

    @staticmethod
    def sine(h, w, feats, device):
        """``PositionEmbeddingSine(feats, normalize=True)`` of an h x w map:
        (2 feats, h, w)."""
        mask = torch.zeros((1, h, w), dtype=torch.bool, device=device)
        not_mask = ~mask
        y_embed = not_mask.cumsum(1, dtype=torch.float32)
        x_embed = not_mask.cumsum(2, dtype=torch.float32)
        scale = 2 * math.pi
        y_embed = y_embed / (y_embed[:, -1:, :] + 1e-6) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + 1e-6) * scale
        dim_t = torch.arange(feats, dtype=torch.float32, device=device)
        dim_t = 10000 ** (2 * (dim_t // 2) / feats)
        pos_x = x_embed[:, :, :, None] / dim_t
        pos_y = y_embed[:, :, :, None] / dim_t
        pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(), pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
        pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(), pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)[0]

    def deform_attn(self, query, src, shapes, name):
        """MSDeformAttn: (S, C) queries and values over the levels
        ``shapes``, reference points the tokens' own pixel centres."""
        s = self.shape
        M, L, P = s["num_attention_heads"], s["num_feature_levels"], s["encoder_n_points"]
        S, C = src.shape
        D = C // M
        value = self.linear(src, f"{name}.value_proj").view(1, S, M, D)
        off = self.linear(query, f"{name}.sampling_offsets").view(1, S, M, L, P, 2)
        attn = torch.softmax(self.linear(query, f"{name}.attention_weights").view(1, S, M, L * P), -1)
        attn = attn.view(1, S, M, L, P)
        refs = []
        for h, w in shapes:
            ref_y, ref_x = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=src.device),
                                          torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=src.device),
                                          indexing="ij")
            refs.append(torch.stack((ref_x.reshape(-1) / w, ref_y.reshape(-1) / h), -1))
        ref = torch.cat(refs)[None, :, None]  # (1, S, 1, 2): every level alike
        normalizer = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=src.device)
        loc = ref[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
        # Deformable DETR's ms_deform_attn_core_pytorch
        values = value.split([h * w for h, w in shapes], dim=1)
        grids = 2 * loc - 1
        sampled = []
        for lid, (h, w) in enumerate(shapes):
            v = values[lid].flatten(2).transpose(1, 2).reshape(M, D, h, w)
            g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # (M, S, P, 2)
            sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
        weights = attn.transpose(1, 2).reshape(M, 1, S, L * P)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1).view(M * D, S)
        return self.linear(out.T, f"{name}.output_proj")

    def pixel_decoder(self, feats):
        """res2 .. res5 -> (the 1/4 map the mask features read, the
        encoder's maps at 1/32, 1/16, 1/8)."""
        d = self.shape["feature_size"]
        srcs = [self.gn(self.conv(x, f"{PD}.input_proj.{i}.0"), f"{PD}.input_proj.{i}.1")
                for i, x in enumerate(feats[1:][::-1])]
        shapes = [tuple(x.shape[-2:]) for x in srcs]
        src = torch.cat([x[0].flatten(1).T for x in srcs])
        pos = torch.cat([self.sine(h, w, d // 2, src.device).flatten(1).T + self.p[f"{PD}.transformer.level_embed"][i]
                         for i, (h, w) in enumerate(shapes)])
        for j in range(self.shape["encoder_layers"]):
            n = f"{PD}.transformer.encoder.layers.{j}"
            src = self.ln(src + self.deform_attn(src + pos, src, shapes, f"{n}.self_attn"), f"{n}.norm1")
            ffn = self.linear(F.relu(self.linear(src, f"{n}.linear1")), f"{n}.linear2")
            src = self.ln(src + ffn, f"{n}.norm2")
        maps, start = [], 0
        for h, w in shapes:
            maps.append(src[start:start + h * w].T.reshape(1, d, h, w))
            start += h * w
        lateral = self.gn(self.conv(feats[0], f"{PD}.adapter_1"), f"{PD}.adapter_1.norm")
        y = lateral + F.interpolate(maps[-1], size=lateral.shape[-2:], mode="bilinear", align_corners=False)
        y = F.relu(self.gn(self.conv(y, f"{PD}.layer_1", padding=1), f"{PD}.layer_1.norm"))
        return y, maps

    # -- transformer decoder -----------------------------------------------

    def attention(self, q, k, v, name, blocked=None):
        """nn.MultiheadAttention with packed projections; ``blocked`` (Q,
        K) True where a query may not attend."""
        M = self.shape["num_attention_heads"]
        w, b = self.p[f"{name}.in_proj_weight"].chunk(3), self.p[f"{name}.in_proj_bias"].chunk(3)
        q, k, v = (self._q(self.linear(x, None, wi, bi)) for x, wi, bi in zip((q, k, v), w, b))
        D = q.shape[-1] // M
        out = torch.empty_like(q)
        for h in range(M):
            cols = slice(h * D, (h + 1) * D)
            for s in range(0, q.shape[0], QUERY_BLOCK):
                rows = slice(s, s + QUERY_BLOCK)
                scores = q[rows, cols] @ k[:, cols].T / math.sqrt(D)
                if blocked is not None:
                    scores = scores.masked_fill(blocked[rows], float("-inf"))
                out[rows, cols] = torch.softmax(scores, dim=-1) @ v[:, cols]
        return self.linear(out, f"{name}.out_proj")

    def predict(self, output, mf):
        """(class logits (Q, K + 1), mask logits (Q, h, w), the normalised
        queries) of the decoder's queries over the mask features (C, h,
        w)."""
        x = self.ln(output, f"{PR}.decoder_norm")
        cls = self.linear(x, f"{PR}.class_embed")
        e = F.relu(self.linear(x, f"{PR}.mask_embed.layers.0"))
        e = F.relu(self.linear(e, f"{PR}.mask_embed.layers.1"))
        e = self.linear(e, f"{PR}.mask_embed.layers.2")
        return cls, torch.einsum("qc,chw->qhw", self._q(e), self._q(mf)), x

    def decoder(self, maps, mf, masks=None):
        s = self.shape
        d, levels = s["hidden_dim"], s["num_feature_levels"]
        src = [x[0].flatten(1).T + self.p[f"{PR}.level_embed.weight"][i] for i, x in enumerate(maps)]
        pos = [self.sine(*x.shape[-2:], d // 2, x.device).flatten(1).T for x in maps]
        query_pos = self.p[f"{PR}.query_embed.weight"]
        output = self.p[f"{PR}.query_feat.weight"]
        cls, mask, _ = self.predict(output, mf)
        attn_logits, used = [], []
        for i in range(s["decoder_layers"] - 1):
            level = i % levels
            logits = F.interpolate(mask[None], size=maps[level].shape[-2:], mode="bilinear",
                                   align_corners=False)[0].flatten(1)
            attn_logits.append(logits)
            blocked = (logits.sigmoid() < 0.5) if masks is None else masks[i].to(logits.device).bool().clone()
            used.append(blocked.clone())
            blocked[torch.where(blocked.sum(-1) == blocked.shape[-1])] = False
            n = f"{PR}.transformer_cross_attention_layers.{i}"
            att = self.attention(output + query_pos, src[level] + pos[level], src[level], f"{n}.multihead_attn",
                                 blocked)
            output = self.ln(output + att, f"{n}.norm")
            n = f"{PR}.transformer_self_attention_layers.{i}"
            q = output + query_pos
            output = self.ln(output + self.attention(q, q, output, f"{n}.self_attn"), f"{n}.norm")
            n = f"{PR}.transformer_ffn_layers.{i}"
            ffn = self.linear(F.relu(self.linear(output, f"{n}.linear1")), f"{n}.linear2")
            output = self.ln(output + ffn, f"{n}.norm")
            cls, mask, queries = self.predict(output, mf)
        return {"class_logits": cls, "mask_logits": mask, "attn_logits": attn_logits, "masks": used,
                "queries": queries}

    @staticmethod
    def frame(image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (1, 3, H, W) float32, normalised."""
        x = image.to(torch.float32).permute(2, 0, 1)
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=x.device)[:, None, None]
        return ((x - mean) / std)[None]

    def features(self, image: torch.Tensor):
        """(H, W, 3) uint8 -> (the 1/4 map the mask features read, the
        encoder's three maps), TF32 off."""
        with torch.no_grad(), _exact():
            return self.pixel_decoder(self.backbone(self.frame(image)))

    @torch.no_grad()
    def forward(self, image: torch.Tensor, masks=None) -> dict:
        """(H, W, 3) uint8 -> {"class_logits" (Q, K + 1), "mask_logits" (Q,
        H / 4, W / 4), "attn_logits" (each layer's resized mask logits,
        (Q, h_i * w_i)), "masks" (the blocked keys each layer used),
        "queries" (the last prediction's normalised queries), "memory"
        (the deformable encoder's output tokens (S, C), coarsest level
        first)}, with TF32 off; ``masks``, the program's attention masks a layer, in
        place of its own (teacher forcing)."""
        y, maps = self.features(image)
        with _exact():
            mf = self.conv(y, f"{PD}.mask_features")[0]
            out = self.decoder(maps, mf, masks)
        out["memory"] = torch.cat([x[0].flatten(1).T for x in maps])
        return out

    @staticmethod
    def semantic(class_logits: torch.Tensor, mask_logits: torch.Tensor, size) -> torch.Tensor:
        """(K, H, W) scores at ``size``: ``softmax(class)[:, :-1]^T .
        sigmoid(mask)``, the masks resized bilinearly first."""
        probs = torch.softmax(class_logits, dim=-1)[..., :-1]
        masks = F.interpolate(mask_logits[None], size=tuple(size), mode="bilinear", align_corners=False)[0]
        with _exact():
            return torch.einsum("qc,qhw->chw", probs, masks.sigmoid())


# random_state: the decoder's attention, as a trained one, peaked and
# query-specific: Q and K drawn QK_GAIN times the trained scale (scores
# of deviation ~QK_GAIN^2 before the softmax) and the output projection
# OUT_GAIN times it; at N(0, 1 / fan_in) the 100 queries each average
# their keys near uniformly, and nine layers collapse them into one
QK_GAIN, OUT_GAIN = 2.0, 0.5


def random_state(seed: int, shape: dict) -> dict[str, torch.Tensor]:
    """A float32 state dict under detectron2's names for ``shape``, in the
    modules' order, drawn on the CPU from ``seed``: convolution weights N(0, 2 / fan_out)
    (detectron2's ``c2_msra_fill``), Linear and attention projections
    N(0, 1 / fan_in), a trained layer's scale, every bias N(0, 0.1^2);
    BatchNorm, GroupNorm and LayerNorm weights U(0.5, 1.5) and biases
    N(0, 0.2^2), BatchNorm's running mean N(0, 0.5^2) and variance
    U(0.5, 1.5); the level embeddings, query features and positions
    N(0, 1); the sampling offsets' bias the published ring (head h
    points at angle 2 pi h / heads, point p at p + 1 cells) plus
    N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    state: dict[str, torch.Tensor] = {}

    def normal(name, size, std, mean=0.0):
        state[name] = torch.randn(size, generator=g) * std + mean

    def uniform(name, size, lo, hi):
        state[name] = lo + (hi - lo) * torch.rand(size, generator=g)

    def linear(name, cin, cout):
        normal(f"{name}.weight", (cout, cin), 1.0 / math.sqrt(cin))
        normal(f"{name}.bias", (cout,), 0.1)

    def conv(name, cin, cout, k, bias=False):
        normal(f"{name}.weight", (cout, cin, k, k), math.sqrt(2.0 / (k * k * cout)))
        if bias:
            normal(f"{name}.bias", (cout,), 0.1)

    def norm(name, c):
        uniform(f"{name}.weight", (c,), 0.5, 1.5)
        normal(f"{name}.bias", (c,), 0.2)

    def frozen_bn(name, c):
        norm(name, c)
        normal(f"{name}.running_mean", (c,), 0.5)
        uniform(f"{name}.running_var", (c,), 0.5, 1.5)

    b = shape["backbone_config"]
    stem = b["embedding_size"]
    conv("backbone.stem.conv1", 3, stem, 7)
    frozen_bn("backbone.stem.conv1.norm", stem)
    cin = stem
    for i, (cout, depth) in enumerate(zip(b["hidden_sizes"], b["depths"])):
        inner = cout // 4
        for j in range(depth):
            n = f"backbone.res{i + 2}.{j}"
            if j == 0:
                conv(f"{n}.shortcut", cin, cout, 1)
                frozen_bn(f"{n}.shortcut.norm", cout)
            for k, (ci, co, ks) in enumerate(((cin if j == 0 else cout, inner, 1), (inner, inner, 3),
                                              (inner, cout, 1))):
                conv(f"{n}.conv{k + 1}", ci, co, ks)
                frozen_bn(f"{n}.conv{k + 1}.norm", co)
        cin = cout
    d, M = shape["feature_size"], shape["num_attention_heads"]
    L, P = shape["num_feature_levels"], shape["encoder_n_points"]
    for i, c in enumerate(b["hidden_sizes"][1:][::-1]):
        conv(f"{PD}.input_proj.{i}.0", c, d, 1, bias=True)
        norm(f"{PD}.input_proj.{i}.1", d)
    normal(f"{PD}.transformer.level_embed", (L, d), 1.0)
    ring = torch.stack([torch.cos(2 * math.pi * torch.arange(M) / M), torch.sin(2 * math.pi * torch.arange(M) / M)], -1)
    ring = ring / ring.abs().max(-1, keepdim=True)[0]
    ring = ring[:, None, None, :].repeat(1, L, P, 1) * torch.arange(1, P + 1, dtype=torch.float32)[None, None, :, None]
    for j in range(shape["encoder_layers"]):
        n = f"{PD}.transformer.encoder.layers.{j}"
        linear(f"{n}.self_attn.sampling_offsets", d, M * L * P * 2)
        state[f"{n}.self_attn.sampling_offsets.bias"] = ring.flatten() + 0.1 * torch.randn(M * L * P * 2, generator=g)
        linear(f"{n}.self_attn.attention_weights", d, M * L * P)
        linear(f"{n}.self_attn.value_proj", d, d)
        linear(f"{n}.self_attn.output_proj", d, d)
        norm(f"{n}.norm1", d)
        linear(f"{n}.linear1", d, shape["encoder_feedforward_dim"])
        linear(f"{n}.linear2", shape["encoder_feedforward_dim"], d)
        norm(f"{n}.norm2", d)
    conv(f"{PD}.adapter_1", b["hidden_sizes"][0], d, 1)
    norm(f"{PD}.adapter_1.norm", d)
    conv(f"{PD}.layer_1", d, d, 3)
    norm(f"{PD}.layer_1.norm", d)
    conv(f"{PD}.mask_features", d, shape["mask_feature_size"], 1, bias=True)
    h, n_layers = shape["hidden_dim"], shape["decoder_layers"] - 1
    for kind, attn in (("self", "self_attn"), ("cross", "multihead_attn")):
        for i in range(n_layers):
            n = f"{PR}.transformer_{kind}_attention_layers.{i}"
            normal(f"{n}.{attn}.in_proj_weight", (3 * h, h), 1.0 / math.sqrt(h))
            state[f"{n}.{attn}.in_proj_weight"][:2 * h] *= QK_GAIN
            normal(f"{n}.{attn}.in_proj_bias", (3 * h,), 0.1)
            linear(f"{n}.{attn}.out_proj", h, h)
            state[f"{n}.{attn}.out_proj.weight"] *= OUT_GAIN
            norm(f"{n}.norm", h)
    for i in range(n_layers):
        n = f"{PR}.transformer_ffn_layers.{i}"
        linear(f"{n}.linear1", h, shape["dim_feedforward"])
        linear(f"{n}.linear2", shape["dim_feedforward"], h)
        norm(f"{n}.norm", h)
    norm(f"{PR}.decoder_norm", h)
    for name in ("query_feat", "query_embed"):
        normal(f"{PR}.{name}.weight", (shape["num_queries"], h), 1.0)
    normal(f"{PR}.level_embed.weight", (L, h), 1.0)
    linear(f"{PR}.class_embed", h, shape["num_labels"] + 1)
    for i in range(3):
        linear(f"{PR}.mask_embed.layers.{i}", h, h if i < 2 else shape["mask_feature_size"])
    return state


# fit_heads' constants: the mask MLP's linear path keeps its unit above
# zero by BIAS; a query is empty above the EMPTY_SHARE quantile of v2 . n,
# its mask falling by EMPTY a unit of v2 . n above it; the class logits of
# the drivable and the other class move by KAPPA a unit of v1 . n about
# its median, no-object's by KAPPA_EMPTY a unit of v2 . n above the
# quantile; the mask MLP's other outputs keep NOISE of their drawn
# weights; the median and the quantile are taken again from the queries
# the set heads give, ROUNDS times in all, each time moved DAMP of the
# way to the new reading
BIAS, EMPTY, EMPTY_SHARE, KAPPA, KAPPA_EMPTY, NOISE, ROUNDS, DAMP = 4.0, 20.0, 0.8, 2.0, 4.0, 0.05, 8, 0.5


def fit_heads(state: dict, shape: dict, images: list, targets: list, device) -> dict:
    """``state`` with the heads set so that the output segments a frame's
    ``targets`` ((H, W) bool, the drivable pixels) from weights that are
    otherwise random:

    - the mask features' channel 0 by ridge least squares (float64, on
      the reference's float32 1/4 map of ``images`` and a constant) to
      the asphalt score ``LOGIT_SCALE (2 y - 1)``, y each 4x4 block's
      share of ``targets``; channel 1 the constant 1;
    - two directions v1, v2 of the decoder's normalised queries n: the
      first two principal axes of the last prediction's queries on
      ``images`` (their mean taken out, and the mean and the decoder
      norm's bias projected out of the axes), each scaled to a unit
      deviation over those queries; t2 the EMPTY_SHARE quantile of
      ``v2 . n`` over them, m1 the median of ``v1 . n`` over those below
      t2; carried linearly through the mask MLP's units 0 and 1, so that
      the mask embedding's channel 0 is ``v1 . n - m1``, its channel 1
      ``-EMPTY relu(v2 . n - t2)``, its other channels NOISE of their
      drawn values: a query's mask logits are ``v1 . n - m1`` times the
      asphalt score, lowered below zero everywhere for the queries well
      above t2 (empty masks, whose rows the attention releases);
    - the class linear: the drivable class ``KAPPA (v1 . n - m1)``, class
      0 its negative, no-object ``KAPPA_EMPTY (v2 . n - t2)``, the other
      classes a tenth of their drawn weights and their biases lowered by
      1.5 LOGIT_SCALE.

    Half the queries that are not empty then mask the asphalt and call
    it drivable, the other half mask the rest and call it class 0. The
    heads steer the decoder through its attention masks, and the queries
    that mask the asphalt drift to the other side of m1 (a set m1 read
    anew swings from one side to the other), so m1 and t2 are read again
    from the queries the set heads give, ROUNDS times in all, each time
    moved DAMP of the way to the new reading (the directions stay those
    of the drawn heads' queries)."""
    out = {k: v.clone() for k, v in state.items()}
    ref = Mask2Former(state, shape, device)
    gram = moment = 0.0
    frames = [torch.as_tensor(image, device=device) for image in images]
    for image, target in zip(frames, targets):
        y, _ = ref.features(image)
        f = y[0].flatten(1).T.double()
        a = torch.cat([f, torch.ones_like(f[:, :1])], dim=1)
        share = F.avg_pool2d(torch.as_tensor(target, device=device, dtype=torch.float64)[None, None], 4)
        gram = gram + a.T @ a
        moment = moment + a.T @ (LOGIT_SCALE * (2.0 * share.flatten() - 1.0))
    ridge = 0.1 * torch.trace(gram) / len(gram)
    w = torch.linalg.solve(gram + ridge * torch.eye(len(gram), dtype=gram.dtype, device=gram.device), moment)
    w = w.float().cpu()
    mf = f"{PD}.mask_features"
    out[f"{mf}.weight"][0, :, 0, 0], out[f"{mf}.bias"][0] = w[:-1], w[-1]
    out[f"{mf}.weight"][1].zero_()
    out[f"{mf}.bias"][1] = 1.0
    drawn = {k: out[k].clone() for k in out if k.startswith((f"{PR}.mask_embed.", f"{PR}.class_embed."))}
    for r in range(ROUNDS):
        ref = Mask2Former(out, shape, device)
        n = torch.cat([ref.forward(image)["queries"] for image in frames]).double().cpu()
        if r == 0:
            v1, v2 = _directions(n, out[f"{PR}.decoder_norm.bias"].double())
        p1, p2 = n.float() @ v1, n.float() @ v2
        t2_now = float(torch.quantile(p2, EMPTY_SHARE))
        m1_now = float(p1[p2 < t2_now].median())
        m1 = m1_now if r == 0 else m1 + DAMP * (m1_now - m1)
        t2 = t2_now if r == 0 else t2 + DAMP * (t2_now - t2)
        _set_heads(out, drawn, v1, v2, m1, t2)
    return out


def _directions(n: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first two principal axes of the queries ``n`` (rows) with their
    mean and ``bias`` projected out, each scaled to a unit deviation of
    the queries along it."""
    mean = n.mean(0)
    c = n - mean
    out = []
    basis = [mean / mean.norm(), bias / bias.norm()]
    for v in torch.linalg.eigh(c.T @ c)[1].T.flip(0):
        for u in basis:
            v = v - (v @ u) * u
        if v.norm() < 0.5:
            continue
        v = v / v.norm()
        basis.append(v)
        out.append(v / (c @ v).std())
        if len(out) == 2:
            return out[0].float(), out[1].float()
    raise ValueError("the queries span fewer than two directions")


def _set_heads(out: dict, drawn: dict, v1: torch.Tensor, v2: torch.Tensor, m1: float, t2: float):
    m = f"{PR}.mask_embed.layers"
    w0, b0 = out[f"{m}.0.weight"], out[f"{m}.0.bias"]
    w0.copy_(drawn[f"{m}.0.weight"])
    b0.copy_(drawn[f"{m}.0.bias"])
    w0[0], b0[0] = v1, BIAS - m1
    w0[1], b0[1] = v2, -t2
    w1, b1 = out[f"{m}.1.weight"], out[f"{m}.1.bias"]
    w1.copy_(drawn[f"{m}.1.weight"])
    b1.copy_(drawn[f"{m}.1.bias"])
    w1[:, :2] = 0.0
    w1[:2], b1[:2] = 0.0, 0.0
    w1[0, 0], w1[1, 1] = 1.0, 1.0
    w2, b2 = out[f"{m}.2.weight"], out[f"{m}.2.bias"]
    w2.copy_(drawn[f"{m}.2.weight"] * NOISE)
    b2.copy_(drawn[f"{m}.2.bias"] * NOISE)
    w2[:, :2] = 0.0
    w2[:2], b2[0], b2[1] = 0.0, -BIAS, 0.0
    w2[0, 0], w2[1, 1] = 1.0, -EMPTY
    c = f"{PR}.class_embed"
    wc, bc = out[f"{c}.weight"], out[f"{c}.bias"]
    wc.copy_(drawn[f"{c}.weight"] * 0.1)
    bc.copy_(drawn[f"{c}.bias"] - 1.5 * LOGIT_SCALE)
    wc[1], bc[1] = KAPPA * v1, -KAPPA * m1
    wc[0], bc[0] = -KAPPA * v1, KAPPA * m1
    wc[-1], bc[-1] = KAPPA_EMPTY * v2, -KAPPA_EMPTY * t2
