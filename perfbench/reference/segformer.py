"""Plain reference of SegFormer (Xie et al., NeurIPS 2021,
arXiv:2105.15203) as functional PyTorch in float32, on a state dict
under ``transformers``' ``SegformerForSemanticSegmentation`` names,
with the shape (widths, depths, heads, reductions, patches, strides,
ratios, the decoder's width) given as a dict under the same config
names.

The forward as published (mmseg's MiT and all-MLP head):

- four stages, each an overlapping patch embedding (convolution of
  kernel k, stride s, padding k // 2, then LayerNorm), blocks of
  ``x + Attn(LN(x))`` then ``x + FFN(LN(x))``, and a closing LayerNorm;
- Attn: Q of the tokens; K and V of the tokens reduced by a convolution
  of kernel and stride R and a LayerNorm where R > 1; per head of 64,
  softmax(Q K^T / 8) V, computed in blocks of ``QUERY_BLOCK`` queries so
  that stage 1 at 1280x736 fits; an output projection;
- Mix-FFN: Linear(C -> 4C), depthwise 3x3 convolution with bias, exact
  GELU, Linear(4C -> C);
- the head: each stage through Linear(C_i -> 768), bilinear resizing to
  stage 1's grid (corners not aligned), the four concatenated deepest
  first, a 1x1 convolution without bias, BatchNorm on running statistics,
  ReLU and a 1x1 convolution to the classes, at stage 1's grid
  (``coarse_logits``); ``logits`` resizes them bilinearly (corners not
  aligned) to the frame.

Departures from the published description: the frame is the (H, W, 3)
uint8 divided by 255, without ImageNet's mean and deviation (the
segmenter input of the agent this model serves); every LayerNorm takes
eps 1e-6 as mmseg's MiT does (``transformers`` uses 1e-5 inside the
encoder); the classes are the agent's 10, not Cityscapes' 19; dropout
and drop-path are identities (inference).

It computes in float32, with TF32 off while it runs.
``fp8=True`` is the control, one precision below the bfloat16 the
configuration states: every linear's and convolution's input and
weight, and Q, K and V, rounded to float8 e4m3 with one scale per
tensor (as ``reference/fpn.py`` rounds its convolutions).

Weights for the benchmark are drawn here, not by the program:
``random_state`` gives every parameter and statistic a non-trivial value
(biases, LayerNorm and BatchNorm affine parameters and BatchNorm's
running statistics included), and ``fit_classifier`` then sets the last
1x1 convolution by least squares on the head's features of a few frames,
so that class 1 (drivable) reads a target mask of those frames: a mask
with a real share of the frame drivable, whose track limits and fits
are determined, from weights that are otherwise random.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.fpn import _fp8

LN_EPS = 1e-6
BN_EPS = 1e-5
HEAD_DIM = 64
QUERY_BLOCK = 8192
# the fitted logits: class 1 at +-LOGIT_SCALE where the target's 4x4
# block is all drivable or all not, class 0 its negative
LOGIT_SCALE = 4.0

SHAPE_KEYS = ("hidden_sizes", "depths", "num_attention_heads", "sr_ratios", "patch_sizes", "strides",
              "mlp_ratios", "decoder_hidden_size", "num_labels")


class SegFormer:
    def __init__(self, state: dict, shape: dict, device, fp8: bool = False):
        self.p = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32) for k, v in state.items()}
        self.shape = {k: shape[k] for k in SHAPE_KEYS}
        self.fp8 = fp8

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.fp8 else t

    def linear(self, x, name):
        return F.linear(self._q(x), self._q(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"))

    def conv(self, x, name, stride=1, padding=0, groups=1):
        return F.conv2d(self._q(x), self._q(self.p[f"{name}.weight"]), self.p.get(f"{name}.bias"),
                        stride=stride, padding=padding, groups=groups)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"], LN_EPS)

    @staticmethod
    def to_tokens(x):
        """(1, C, H, W) -> (H * W, C)."""
        return x[0].flatten(1).T

    @staticmethod
    def to_map(t, h, w):
        """(H * W, C) -> (1, C, H, W)."""
        return t.T.reshape(1, -1, h, w)

    def attention(self, q, k, v, heads):
        """softmax(Q K^T / sqrt(64)) V per head, queries in blocks."""
        q, k, v = self._q(q), self._q(k), self._q(v)
        out = torch.empty_like(q)
        for h in range(heads):
            cols = slice(h * HEAD_DIM, (h + 1) * HEAD_DIM)
            kh, vh = k[:, cols], v[:, cols]
            for s in range(0, q.shape[0], QUERY_BLOCK):
                rows = slice(s, s + QUERY_BLOCK)
                scores = q[rows, cols] @ kh.T / math.sqrt(HEAD_DIM)
                out[rows, cols] = torch.softmax(scores, dim=-1) @ vh
        return out

    def block(self, t, name, h, w, heads, sr):
        a = f"{name}.attention.self"
        x = self.ln(t, f"{name}.layer_norm_1")
        q = self.linear(x, f"{a}.query")
        if sr > 1:
            x = self.to_tokens(self.conv(self.to_map(x, h, w), f"{a}.sr", stride=sr))
            x = self.ln(x, f"{a}.layer_norm")
        att = self.attention(q, self.linear(x, f"{a}.key"), self.linear(x, f"{a}.value"), heads)
        t = t + self.linear(att, f"{name}.attention.output.dense")
        x = self.linear(self.ln(t, f"{name}.layer_norm_2"), f"{name}.mlp.dense1")
        c4 = x.shape[-1]
        x = self.to_tokens(self.conv(self.to_map(x, h, w), f"{name}.mlp.dwconv.dwconv", padding=1, groups=c4))
        return t + self.linear(F.gelu(x), f"{name}.mlp.dense2")

    def features(self, x):
        """(1, 3, H, W) -> each stage's output (1, C_i, H_i, W_i)."""
        s, e = self.shape, "segformer.encoder"
        feats = []
        for i in range(len(s["hidden_sizes"])):
            k = s["patch_sizes"][i]
            x = self.conv(x, f"{e}.patch_embeddings.{i}.proj", stride=s["strides"][i], padding=k // 2)
            h, w = x.shape[-2:]
            t = self.ln(self.to_tokens(x), f"{e}.patch_embeddings.{i}.layer_norm")
            for j in range(s["depths"][i]):
                t = self.block(t, f"{e}.block.{i}.{j}", h, w, s["num_attention_heads"][i], s["sr_ratios"][i])
            x = self.to_map(self.ln(t, f"{e}.layer_norm.{i}"), h, w)
            feats.append(x)
        return feats

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) in [0, 1] -> the head's features (1, 768, H / 4,
        W / 4), after BatchNorm and ReLU, before the classifier."""
        feats = self.features(x)
        size = feats[0].shape[-2:]
        parts = []
        for i, f in enumerate(feats):
            y = self.to_map(self.linear(self.to_tokens(f), f"decode_head.linear_c.{i}.proj"), *f.shape[-2:])
            parts.append(F.interpolate(y, size=size, mode="bilinear", align_corners=False))
        x = self.conv(torch.cat(parts[::-1], dim=1), "decode_head.linear_fuse")
        bn = "decode_head.batch_norm"
        inv = torch.rsqrt(self.p[f"{bn}.running_var"] + BN_EPS) * self.p[f"{bn}.weight"]
        x = (x - self.p[f"{bn}.running_mean"][:, None, None]) * inv[:, None, None] + self.p[f"{bn}.bias"][:, None, None]
        return F.relu(x)

    @staticmethod
    def frame(image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (1, 3, H, W) float32 in [0, 1]."""
        return (image.to(torch.float32) / 255.0).permute(2, 0, 1)[None]

    @torch.no_grad()
    def coarse_logits(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (num_labels, H / 4, W / 4) float32 logits at
        stage 1's grid, with TF32 off for matrix products and cuDNN's
        convolutions."""
        with _exact():
            return self.conv(self.head(self.frame(image)), "decode_head.classifier")[0]

    def logits(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 -> (num_labels, H, W) float32 logits: the
        coarse logits resized to the frame."""
        return self.resize(self.coarse_logits(image), image.shape[:2])

    @staticmethod
    def resize(coarse: torch.Tensor, size) -> torch.Tensor:
        """(C, h, w) logits resized bilinearly (corners not aligned) to
        (C, *size)."""
        return F.interpolate(coarse[None], size=tuple(size), mode="bilinear", align_corners=False)[0]


class _exact:
    """TF32 off for matrix products and cuDNN's convolutions, restored
    on the way out."""

    def __enter__(self):
        self.flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags


def random_state(seed: int, shape: dict) -> dict[str, torch.Tensor]:
    """A float32 state dict under ``transformers``' names for ``shape``,
    drawn on the CPU from ``seed``. Convolution weights N(0, 2 / fan_out)
    as published; Linear weights N(0, 1 / fan_in), a trained layer's
    scale, where the published N(0, 0.02^2) leaves attention near
    uniform and each block's branches small beside the residual stream,
    so that a fault inside a block would hardly move the logits; and
    where the published initialisation has constants, draws around
    them: every bias N(0, 0.1^2), LayerNorm and BatchNorm weights
    U(0.5, 1.5) and biases N(0, 0.2^2), BatchNorm's running mean
    N(0, 0.5^2) and variance U(0.5, 1.5). The classifier is drawn like
    any convolution, for ``fit_classifier`` to set."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    state: dict[str, torch.Tensor] = {}

    def normal(name, size, std, mean=0.0):
        state[name] = torch.randn(size, generator=g) * std + mean

    def uniform(name, size, lo, hi):
        state[name] = lo + (hi - lo) * torch.rand(size, generator=g)

    def linear(name, cin, cout):
        normal(f"{name}.weight", (cout, cin), 1.0 / math.sqrt(cin))
        normal(f"{name}.bias", (cout,), 0.1)

    def conv(name, cin, cout, k, groups=1, bias=True):
        normal(f"{name}.weight", (cout, cin // groups, k, k), math.sqrt(2.0 / (k * k * cout / groups)))
        if bias:
            normal(f"{name}.bias", (cout,), 0.1)

    def norm(name, c):
        uniform(f"{name}.weight", (c,), 0.5, 1.5)
        normal(f"{name}.bias", (c,), 0.2)

    e = "segformer.encoder"
    widths = [3, *shape["hidden_sizes"]]
    for i, c in enumerate(shape["hidden_sizes"]):
        conv(f"{e}.patch_embeddings.{i}.proj", widths[i], c, shape["patch_sizes"][i])
        norm(f"{e}.patch_embeddings.{i}.layer_norm", c)
    for i, c in enumerate(shape["hidden_sizes"]):
        sr, c4 = shape["sr_ratios"][i], c * shape["mlp_ratios"][i]
        for j in range(shape["depths"][i]):
            b = f"{e}.block.{i}.{j}"
            norm(f"{b}.layer_norm_1", c)
            for k in ("query", "key", "value"):
                linear(f"{b}.attention.self.{k}", c, c)
            if sr > 1:
                conv(f"{b}.attention.self.sr", c, c, sr)
                norm(f"{b}.attention.self.layer_norm", c)
            linear(f"{b}.attention.output.dense", c, c)
            norm(f"{b}.layer_norm_2", c)
            linear(f"{b}.mlp.dense1", c, c4)
            conv(f"{b}.mlp.dwconv.dwconv", c4, c4, 3, groups=c4)
            linear(f"{b}.mlp.dense2", c4, c)
    for i, c in enumerate(shape["hidden_sizes"]):
        norm(f"{e}.layer_norm.{i}", c)
    d = shape["decoder_hidden_size"]
    for i, c in enumerate(shape["hidden_sizes"]):
        linear(f"decode_head.linear_c.{i}.proj", c, d)
    conv("decode_head.linear_fuse", d * len(shape["hidden_sizes"]), d, 1, bias=False)
    bn = "decode_head.batch_norm"
    norm(bn, d)
    normal(f"{bn}.running_mean", (d,), 0.5)
    uniform(f"{bn}.running_var", (d,), 0.5, 1.5)
    state[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    conv("decode_head.classifier", d, shape["num_labels"], 1)
    return state


def fit_classifier(state: dict, shape: dict, images: list, targets: list, device) -> dict:
    """``state`` with the classifier set by ridge least squares (float64)
    on the head's float32 features (and a constant) of ``images`` ((H, W, 3) uint8), so
    that class 1's logit reads LOGIT_SCALE * (2 y - 1) and class 0's its
    negative, y each 4x4 block's share of ``targets`` ((H, W) bool, the
    drivable pixels). The other classes keep a tenth of their drawn
    weights, and their biases are lowered by 1.5 LOGIT_SCALE: their
    logits sit below 0, and so below the larger of classes 0 and 1."""
    ref = SegFormer(state, shape, device)
    gram = moment = 0.0
    with torch.no_grad(), _exact():
        for image, target in zip(images, targets):
            f = ref.head(ref.frame(torch.as_tensor(image, device=device)))[0].flatten(1).T.double()
            a = torch.cat([f, torch.ones_like(f[:, :1])], dim=1)
            y = F.avg_pool2d(torch.as_tensor(target, device=device, dtype=torch.float64)[None, None], 4)
            gram = gram + a.T @ a
            moment = moment + a.T @ (LOGIT_SCALE * (2.0 * y.flatten() - 1.0))
    # a ridge of a tenth of the mean diagonal: a smooth classifier, which
    # amplifies the features' rounding less than the least-squares one
    ridge = 0.1 * torch.trace(gram) / len(gram)
    w1 = torch.linalg.solve(gram + ridge * torch.eye(len(gram), dtype=gram.dtype, device=device), moment).float().cpu()
    out = dict(state)
    weight = state["decode_head.classifier.weight"].clone() * 0.1
    bias = state["decode_head.classifier.bias"].clone()
    weight[1, :, 0, 0], bias[1] = w1[:-1], w1[-1]
    weight[0], bias[0] = -weight[1], -bias[1]
    bias[2:] -= 1.5 * LOGIT_SCALE
    out["decode_head.classifier.weight"], out["decode_head.classifier.bias"] = weight, bias
    return out
