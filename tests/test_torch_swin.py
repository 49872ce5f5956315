"""Mask2Former with a Swin backbone (``models/swin.py``,
``models/mask2former.py``) and the shifted-window attention
(``ops/window_attention.py``) against the plain reference the benchmark
judges the card by (``perfbench/reference/swin.py``), on the CPU in
float32 at a small Swin (embed 32, depths 2/2/2/2, heads 1/2/4/8, window
7) and a 160x224 frame: the 1/4 grid is 40x56, so every stage pads
(40x56, 20x28, 10x14, 5x7 to multiples of 7) and its shifted windows
span the regions' boundaries; with the reference's seeded random weights
(``random_state``: every bias and norm parameter non-trivial, the
relative position tables N(0, 1)). Also the plain window attention
against the published block's composition, the published names and
shapes at Swin-L's widths, no host read in the forward, the perceiver on
the architecture, and the R50 model as it was."""

import dataclasses
import json
import pathlib

import pytest
import torch
import torch.nn.functional as F
from test_torch_mask2former import _HostReads

from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.models import mask2former as M
from acmpc_tpu_torch.models import swin as S
from acmpc_tpu_torch.ops import window_attention as op
from acmpc_tpu_torch.perception import segmentation
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.perception.segmentation import ENTRIES
from perfbench.reference import swin as R

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the same float32 products and sums as the reference in another order
# (oneDNN's convolutions and the Linears on the real tokens against the
# reference's on whole windows, fused attention against blocked softmax):
# some 90 layers of float32 rounding relative to the largest value, near
# 1e-6 (1e-5 with room)
LOGIT_RTOL = 1e-5
SEED = 2**31 + 26
SHAPE = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_swin_l.json").read_text())
SMALL = {"embed_dim": 32, "depths": (2, 2, 2, 2), "num_heads": (1, 2, 4, 8), "window_size": 7}
CUT = {"encoder_layers": 1, "decoder_layers": 4}  # one encoder layer, three masked layers
FRAME = (160, 224)


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _config(**depth) -> M.Mask2FormerConfig:
    return M.Mask2FormerConfig(backbone_config=S.SwinConfig(**SMALL), **depth)


def _shape(cfg: M.Mask2FormerConfig) -> dict:
    out = {k: getattr(cfg, k) for k in R.SHAPE_KEYS if k != "backbone_config"}
    b = cfg.backbone_config
    out["backbone_config"] = {"model_type": "swin", **{k: getattr(b, k) for k in R.SWIN_KEYS}}
    return out


def _model(state: dict, cfg: M.Mask2FormerConfig) -> M.Mask2Former:
    model = M.Mask2Former(cfg)
    model.load_state_dict(state)
    return model.eval()


def _frame(h: int, w: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, generator=g)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_model_matches_the_reference():
    cfg = _config(**CUT)
    shape = _shape(cfg)
    state = R.random_state(SEED, shape)
    image = _frame(*FRAME)
    with torch.no_grad():
        cls, mask, memory, *rest = _model(state, cfg)(image[None])
    masks, feats = rest[:-4], rest[-4:]
    assert cls.shape == (1, 100, 11) and mask.shape == (1, 100, 40, 56) and memory.shape == (1, 35 + 140 + 560, 256)
    assert [tuple(f.shape) for f in feats] == [(1, 32, 40, 56), (1, 64, 20, 28), (1, 128, 10, 14), (1, 256, 5, 7)]
    assert all(f.is_contiguous(memory_format=torch.channels_last) for f in feats)
    assert len(masks) == 3 and all(m.dtype == torch.bool for m in masks)
    ref = R.Mask2Former(state, shape, "cpu")
    want = ref.forward(image, [m[0] for m in masks])
    assert _gap(cls[0], want["class_logits"]) <= LOGIT_RTOL
    assert _gap(mask[0], want["mask_logits"]) <= LOGIT_RTOL
    assert _gap(memory[0], want["memory"]) <= LOGIT_RTOL
    for got, ref_map in zip(feats, ref.backbone_maps(image)):
        assert _gap(got[0], ref_map) <= LOGIT_RTOL
    for bits, logits in zip(masks, want["attn_logits"]):
        decided = logits.abs() > 1e-4 * logits.abs().max()
        assert torch.equal(bits[0][decided], (logits.sigmoid() < 0.5)[decided])


def _published_block_attention(attn: S.WindowAttention, x: torch.Tensor, shift: int) -> torch.Tensor:
    """The published ``SwinTransformerBlock`` between its LN1 and its
    residual: pad the normed map, roll, partition, the qkv Linear of the
    windows, the attention with the bias and the mask, proj, reverse,
    roll back, crop."""
    window, heads = attn.window, attn.heads
    _, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (window - w % window) % window, 0, (window - h % window) % window))
    hp, wp = x.shape[1:3]
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = R.window_partition(x, window).view(-1, window * window, c)
    b_, n, _ = windows.shape
    qkv = attn.qkv(windows).reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    scores = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    table = attn.relative_position_bias_table
    scores = scores + table[attn.relative_position_index.view(-1)].view(n, n, -1).permute(2, 0, 1)[None]
    if shift:
        mask = R.attn_mask(hp, wp, window, shift, x.device)
        scores = (scores.view(b_ // mask.shape[0], mask.shape[0], heads, n, n) + mask[:, None][None]).view(
            b_, heads, n, n)
    out = attn.proj((torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b_, n, c))
    x = R.window_reverse(out.view(-1, window, window, c), window, hp, wp)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x[:, :h, :w]


@pytest.mark.parametrize("shift", [0, 3], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("grid", [(40, 56), (5, 7), (9, 16)], ids=["padded", "one_window_row", "odd"])
def test_plain_window_attention_is_the_published_composition(shift, grid):
    # the qkv Linear of the real tokens then the plain core, against the
    # published block's Linear of the padded windows: a padded token is
    # the Linear of a zero, its bias, bit for bit; the same rows summed in
    # the same order
    g = torch.Generator().manual_seed(11)
    attn = S.WindowAttention(64, 2, 7)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
        x = torch.randn((2, *grid, 64), generator=g)
        got = attn(x, shift)
        want = _published_block_attention(attn, x, shift)
    assert got.shape == want.shape == x.shape
    assert torch.equal(got, want)
    assert not op.window_attention.launches  # the plain version counts no launch


def test_the_shift_mask_and_index_are_the_published():
    idx = op.relative_position_index(7)
    assert torch.equal(idx, R.relative_position_index(7))
    assert int(idx.max()) == 13 * 13 - 1 and int(idx[0, 0]) == 6 * 13 + 6
    mask = op.shift_mask(14, 21, 7, 3)
    assert torch.equal(mask, R.attn_mask(14, 21, 7, 3, "cpu"))
    assert mask.shape == (6, 49, 49) and set(mask.unique().tolist()) == {-100.0, 0.0}
    assert not bool(mask[0].any())  # the first window lies in one region
    assert bool((mask[-1] != 0).any())  # the last holds four


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    qkv = torch.zeros((1, 5, 7, 3 * 64), dtype=torch.bfloat16)
    bias = torch.zeros(3 * 64, dtype=torch.bfloat16)
    table = torch.zeros(13 * 13, 2, dtype=torch.bfloat16)
    assert op._check(qkv, bias, table, 2, 7, 3) == (1, 5, 7, 64)
    with pytest.raises(ValueError, match="heads of 32"):
        op._check(qkv, bias, table, 4, 7, 3)
    with pytest.raises(ValueError, match="windows up to 12"):
        op._check(qkv, bias, torch.zeros(25 * 25, 2, dtype=torch.bfloat16), 2, 13, 0)
    with pytest.raises(ValueError, match="shift below"):
        op._check(qkv, bias, table, 2, 7, 7)
    with pytest.raises(ValueError, match="table"):
        op._check(qkv, bias, torch.zeros(11 * 11, 2, dtype=torch.bfloat16), 2, 7, 0)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        op._check(qkv.half(), bias.half(), table.half(), 2, 7, 0)
    with pytest.raises(TypeError, match="table"):
        op._check(qkv, bias, table.float(), 2, 7, 0)
    with pytest.raises(ValueError, match="contiguous"):
        op._check(torch.zeros((1, 7, 5, 192), dtype=torch.bfloat16).transpose(1, 2), bias, table, 2, 7, 0)


def test_the_forward_reads_nothing_on_the_host():
    cfg = _config(**CUT)
    model = _model(R.random_state(SEED + 2, _shape(cfg)), cfg)
    image = _frame(*FRAME, 2)
    with torch.no_grad(), _HostReads() as reads:
        out = model(image[None])
        M.semantic_scores(out[0], out[1], *FRAME).argmax(dim=1)
    assert reads.seen == []


def test_state_dict_names_and_shapes_are_detectron2s():
    small = _model(R.random_state(SEED, _shape(_config())), _config()).state_dict()
    assert list(small) == list(R.random_state(SEED, _shape(_config())))
    with torch.device("meta"):
        model = ENTRIES["mask2former_swin_l"].model()
    sd = model.state_dict()
    assert model.config.backbone == "swin" and model.config.hidden_sizes == (192, 384, 768, 1536)
    # the same names as the small model's, block for block
    names = [k for k in sd if k.startswith("backbone.")]
    assert len([k for k in names if k.endswith(".attn.qkv.weight")]) == 24
    assert sum(v.numel() for k, v in sd.items() if v.is_floating_point()) == 215_452_799
    assert sum(v.numel() for k, v in sd.items() if v.is_floating_point() and k in names) == 195_201_204
    assert [k for k in sd if not k.startswith("backbone.")] == [k for k in small if not k.startswith("backbone.")]
    pd = "sem_seg_head.pixel_decoder"
    for name, shape in (
        ("backbone.patch_embed.proj.weight", (192, 3, 4, 4)),
        ("backbone.patch_embed.norm.weight", (192,)),
        ("backbone.layers.0.blocks.1.attn.relative_position_bias_table", (23 * 23, 6)),
        ("backbone.layers.0.blocks.1.attn.relative_position_index", (144, 144)),
        ("backbone.layers.0.blocks.0.attn.qkv.weight", (576, 192)),
        ("backbone.layers.0.blocks.0.attn.qkv.bias", (576,)),
        ("backbone.layers.1.blocks.0.attn.proj.weight", (384, 384)),
        ("backbone.layers.2.blocks.17.mlp.fc1.weight", (3072, 768)),
        ("backbone.layers.2.blocks.17.mlp.fc2.weight", (768, 3072)),
        ("backbone.layers.3.blocks.1.attn.relative_position_bias_table", (529, 48)),
        ("backbone.layers.0.downsample.reduction.weight", (384, 768)),
        ("backbone.layers.2.downsample.norm.weight", (3072,)),
        ("backbone.norm0.weight", (192,)),
        ("backbone.norm3.bias", (1536,)),
        (f"{pd}.input_proj.0.0.weight", (256, 1536, 1, 1)),  # res5 first
        (f"{pd}.input_proj.2.0.weight", (256, 384, 1, 1)),
        (f"{pd}.adapter_1.weight", (256, 192, 1, 1)),
    ):
        assert tuple(sd[name].shape) == shape, name
    assert "backbone.layers.3.downsample.reduction.weight" not in sd
    assert "backbone.layers.0.downsample.reduction.bias" not in sd
    assert sd["backbone.layers.1.blocks.0.attn.relative_position_index"].dtype == torch.int64


def test_the_r50_model_is_as_it_was():
    # the ResNet by default: its names (``test_torch_mask2former`` holds
    # them to detectron2's), no Swin module, the outputs without features
    cfg = M.Mask2FormerConfig(**CUT)
    assert cfg.backbone == "resnet" and cfg.backbone_config is None
    assert cfg.hidden_sizes == (256, 512, 1024, 2048)
    model = M.Mask2Former(cfg).eval()
    assert isinstance(model.backbone, M.ResNet) and list(model.state_dict())[0] == "backbone.stem.conv1.weight"
    with torch.no_grad():
        out = model(_frame(64, 96)[None])
    assert len(out) == 3 + 3


def test_perceiver_runs_mask2former_swin(monkeypatch):
    monkeypatch.setattr(M.Mask2FormerConfig, "encoder_layers", 1)
    monkeypatch.setattr(M.Mask2FormerConfig, "decoder_layers", 4)
    monkeypatch.setattr(segmentation, "SwinConfig", lambda: S.SwinConfig(**SMALL))
    cfg = dataclasses.replace(loop.perception_config(FRAME[1], FRAME[0], "fp32"), architecture="mask2former_swin_l",
                              model_path=None)
    state = R.random_state(SEED + 4, _shape(_config(**CUT)))
    perc = Perceiver(cfg, state, device="cpu", keep_logits=True)
    assert perc.segmenter.model.config.backbone == "swin"
    image = _frame(*FRAME, 5)
    out = perc._pipeline(image)
    eager = perc._run_pipeline(image)
    assert isinstance(out.logits, tuple) and len(out.logits) == 3 + 3 + 4
    assert all(torch.equal(a, b) for a, b in zip(out.logits, eager.logits)) and torch.equal(out[0], eager[0])
    scores = M.semantic_scores(out.logits[0], out.logits[1], *FRAME)
    assert torch.equal(out[1], torch.argmax(scores, dim=1)[0].to(torch.uint8))
    full = perc.perceive(image.numpy())
    assert set(full) >= {"left", "right", "centreline", "drivable"}
