"""Plain reference of Mask2Former with a Swin-L backbone (Cheng et al.,
arXiv:2112.01527, facebookresearch/Mask2Former's ``swin/maskformer2_
swin_large_IN21k_384_bs16_90k.yaml``; Liu et al., arXiv:2103.14030, as
Mask2Former's ``D2SwinTransformer``), as functional PyTorch in float32, on
a state dict under detectron2's names, with the shape given as a dict
under ``transformers``' ``Mask2FormerConfig`` names (the backbone's under
``backbone_config`` as ``SwinConfig``'s).

The backbone as published: the 4x4 stride-4 patch embedding and its
LayerNorm; per block ``x + attn(LN1(x))``, ``x + MLP(LN2(x))`` (GELU, erf;
LayerNorm eps 1e-5), ``attn`` the normed map padded with zeros to whole
windows, rolled by ``-window // 2`` in blocks of odd index, partitioned,
the qkv Linear of every window's tokens (the padding's too), ``softmax(q
k^T / sqrt(32) + table[relative_position_index] + attn_mask) v`` with
the published mask (-100 between the rolled map's regions) materialised,
the proj Linear, the partition reversed, rolled back and cropped; patch
merging (the four strided quarters concatenated, LayerNorm(4C), a Linear
to 2C with no bias); the out-norms ``norm0``-``norm3``. The attention
runs ``WINDOW_BLOCK`` windows at a time, so that its scores fit. The
pixel decoder, the masked decoder, teacher forcing and semantic
inference are ``reference/mask2former.py``'s, composed with this
backbone (:class:`Mask2Former` subclasses it).

Departures from the published description: those of
``reference/mask2former.py`` (the frame's channel order and
normalisation, 10 classes, dropout and drop path identities).

It computes in float32, with TF32 off while it runs. ``fp8=True`` is the
control, one precision below the bfloat16 the configuration states:
every linear's and convolution's input and weight, and the attention's
Q, K and V, rounded to float8 e4m3 with one scale per tensor.

Weights for the benchmark are drawn here (``random_state``: the backbone
with the same kinds of draws as ``reference/mask2former.random_state``,
the relative position tables N(0, 1) so that the bias moves the softmax;
the rest by that function), and ``fit_heads`` sets the heads as
``reference/mask2former.fit_heads`` does, on this model's features.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from perfbench.reference import mask2former as R
from perfbench.reference.segformer import _exact

WINDOW_BLOCK = 64  # windows a step of the attention (stage 1 of 1280x736 has 432)
MASKED = -100.0  # the published attn_mask between the rolled map's regions
SHAPE_KEYS = R.SHAPE_KEYS
SWIN_KEYS = ("embed_dim", "depths", "num_heads", "window_size", "mlp_ratio", "patch_size")
# random_state draws the backbone from the seed's own stream, apart from
# the rest's (reference/mask2former.random_state's, of the same seed)
BACKBONE_STREAM = 0x5317


def hidden_sizes(shape: dict) -> list[int]:
    b = shape["backbone_config"]
    return [b["embed_dim"] * 2 ** i for i in range(len(b["depths"]))]


def relative_position_index(window: int) -> torch.Tensor:
    """The published ``relative_position_index`` (window^2, window^2)."""
    coords = torch.stack(torch.meshgrid([torch.arange(window), torch.arange(window)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x, window):
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def window_reverse(windows, window, h, w):
    b = int(windows.shape[0] / (h * w / window / window))
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attn_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """The published ``BasicLayer`` mask of the padded (hp, wp) map."""
    img_mask = torch.zeros((1, hp, wp, 1), device=device)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, window).view(-1, window * window)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASKED).masked_fill(mask == 0, 0.0)


class Mask2Former(R.Mask2Former):
    """``reference/mask2former.Mask2Former`` with the Swin backbone."""

    def __init__(self, state: dict, shape: dict, device, fp8: bool = False):
        super().__init__(state, shape, device, fp8)
        b = shape["backbone_config"]
        self.swin = {k: b[k] for k in SWIN_KEYS}
        self.index = relative_position_index(b["window_size"]).to(device)

    def window_attention(self, x, name, heads, shift):
        """The published ``WindowAttention`` over the normed (1, H, W, C)
        map, padding, roll, partition and their reverses included."""
        window = self.swin["window_size"]
        _, h, w, c = x.shape
        pad_r, pad_b = (window - w % window) % window, (window - h % window) % window
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = x.shape[1:3]
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = attn_mask(hp, wp, window, shift, x.device)
        windows = window_partition(x, window).view(-1, window * window, c)
        n = window * window
        table = self.p[f"{name}.relative_position_bias_table"]
        bias = table[self.index.view(-1)].view(n, n, -1).permute(2, 0, 1).contiguous()
        out = torch.empty_like(windows)
        for s in range(0, windows.shape[0], WINDOW_BLOCK):
            rows = slice(s, s + WINDOW_BLOCK)
            qkv = self.linear(windows[rows], f"{name}.qkv")
            q, k, v = (self._q(t) for t in qkv.reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4))
            attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1) + bias[None]
            if shift:
                attn = attn + mask[rows][:, None]
            attn = torch.softmax(attn, dim=-1)
            out[rows] = (attn @ v).transpose(1, 2).reshape(-1, n, c)
        out = self.linear(out, f"{name}.proj")
        x = window_reverse(out.view(-1, window, window, c), window, hp, wp)
        if shift:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        return x[:, :h, :w].contiguous()

    def backbone(self, x):
        """(1, 3, H, W) normalised -> res2 .. res5 (1, C, h, w)."""
        s = self.swin
        x = self.conv(x, "backbone.patch_embed.proj", stride=s["patch_size"]).permute(0, 2, 3, 1)
        x = self.ln(x, "backbone.patch_embed.norm")
        out = []
        for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
            if i > 0:
                n = f"backbone.layers.{i - 1}.downsample"
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
                x = self.linear(self.ln(x, f"{n}.norm"), f"{n}.reduction")
            for j in range(depth):
                n = f"backbone.layers.{i}.blocks.{j}"
                shift = 0 if j % 2 == 0 else s["window_size"] // 2
                x = x + self.window_attention(self.ln(x, f"{n}.norm1"), f"{n}.attn", heads, shift)
                y = F.gelu(self.linear(self.ln(x, f"{n}.norm2"), f"{n}.mlp.fc1"))
                x = x + self.linear(y, f"{n}.mlp.fc2")
            out.append(self.ln(x, f"backbone.norm{i}").permute(0, 3, 1, 2))
        return out

    @torch.no_grad()
    def backbone_maps(self, image: torch.Tensor) -> list[torch.Tensor]:
        """(H, W, 3) uint8 -> res2 .. res5 (C, h, w), TF32 off."""
        with _exact():
            return [x[0] for x in self.backbone(self.frame(image))]


def random_state(seed: int, shape: dict) -> dict[str, torch.Tensor]:
    """A float32 state dict under detectron2's names for ``shape``, in the
    modules' order: the Swin backbone drawn on the CPU from the seed's
    own stream (the patch embedding's convolution N(0, 2 / fan_out) as
    ``c2_msra_fill``, Linear weights N(0, 1 / fan_in), every bias N(0,
    0.1^2), LayerNorm weights U(0.5, 1.5) and biases N(0, 0.2^2), the
    relative position tables N(0, 1), the index as published), then the
    pixel decoder and the masked decoder as
    ``reference/mask2former.random_state`` draws them for these widths."""
    g = torch.Generator().manual_seed((int(seed) ^ BACKBONE_STREAM) % (1 << 63))
    state: dict[str, torch.Tensor] = {}

    def normal(name, size, std):
        state[name] = torch.randn(size, generator=g) * std

    def linear(name, cin, cout, bias=True):
        normal(f"{name}.weight", (cout, cin), 1.0 / math.sqrt(cin))
        if bias:
            normal(f"{name}.bias", (cout,), 0.1)

    def norm(name, c):
        state[f"{name}.weight"] = 0.5 + torch.rand((c,), generator=g)
        normal(f"{name}.bias", (c,), 0.2)

    b = shape["backbone_config"]
    widths, window, patch = hidden_sizes(shape), b["window_size"], b["patch_size"]
    normal("backbone.patch_embed.proj.weight", (widths[0], 3, patch, patch),
           math.sqrt(2.0 / (patch * patch * widths[0])))
    normal("backbone.patch_embed.proj.bias", (widths[0],), 0.1)
    norm("backbone.patch_embed.norm", widths[0])
    for i, (c, depth, heads) in enumerate(zip(widths, b["depths"], b["num_heads"])):
        for j in range(depth):
            n = f"backbone.layers.{i}.blocks.{j}"
            norm(f"{n}.norm1", c)
            normal(f"{n}.attn.relative_position_bias_table", ((2 * window - 1) ** 2, heads), 1.0)
            state[f"{n}.attn.relative_position_index"] = relative_position_index(window)
            linear(f"{n}.attn.qkv", c, 3 * c)
            linear(f"{n}.attn.proj", c, c)
            norm(f"{n}.norm2", c)
            hidden = int(c * b["mlp_ratio"])
            linear(f"{n}.mlp.fc1", c, hidden)
            linear(f"{n}.mlp.fc2", hidden, c)
        if i < len(widths) - 1:
            linear(f"backbone.layers.{i}.downsample.reduction", 4 * c, 2 * c, bias=False)
            norm(f"backbone.layers.{i}.downsample.norm", 4 * c)
    for i, c in enumerate(widths):
        norm(f"backbone.norm{i}", c)
    # the rest for a ResNet of no blocks with Swin's widths: its stem, the
    # only backbone draw, is dropped
    rest = R.random_state(seed, {**shape, "backbone_config": {"embedding_size": 1, "hidden_sizes": widths,
                                                              "depths": [0] * len(widths)}})
    state.update((k, v) for k, v in rest.items() if not k.startswith("backbone."))
    return state


@contextlib.contextmanager
def _swin_model():
    """``reference/mask2former``'s functions build this module's model
    while it is open (``fit_heads`` builds the reference by that name)."""
    plain = R.Mask2Former
    R.Mask2Former = Mask2Former
    try:
        yield
    finally:
        R.Mask2Former = plain


def fit_heads(state: dict, shape: dict, images: list, targets: list, device) -> dict:
    """``reference/mask2former.fit_heads`` (its docstring says how) on this
    model: the heads set from the Swin-backed reference's features and
    queries."""
    with _swin_model():
        return R.fit_heads(state, shape, images, targets, device)
