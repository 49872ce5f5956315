"""Mask2Former-R50 (``models/mask2former.py``) and the deformable
attention's sampling (``ops/ms_deform_attn.py``) against the plain
reference the benchmark judges the card by
(``perfbench/reference/mask2former.py``), on the CPU at small frames, in
float32, with the reference's seeded random weights (``random_state``:
every bias, norm parameter and statistic non-trivial); the published
names and shapes; the elementwise release of fully masked rows against
the published in-place rule; no host read in the forward; the segmenter
and the perceiver built from ``perception.architecture``."""

import dataclasses
import json
import pathlib

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.models import mask2former as M
from acmpc_tpu_torch.ops import ms_deform_attn as op
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.perception.segmentation import ENTRIES, TrackSegmenter
from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
from perfbench.reference.mask2former import Mask2Former as Reference
from perfbench.reference.mask2former import SHAPE_KEYS, random_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the same float32 products and sums as the reference in another order
# (oneDNN's convolutions against the reference's, fused attention against
# blocked softmax, the kernel's bilinear taps against grid_sample's,
# whose unnormalisation rounds differently): some 70 layers of float32
# rounding relative to the largest logit, near 1e-6 (1e-5 with room)
LOGIT_RTOL = 1e-5
# the same taps and weights, summed in another order, in float32
SAMPLE_ATOL = 1e-6
SEED = 2**31 + 24
SHAPE = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_r50.json").read_text())
CUT = {"encoder_layers": 1, "decoder_layers": 4}  # one encoder layer, three masked layers


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _shape(cfg: M.Mask2FormerConfig) -> dict:
    out = {k: getattr(cfg, k) for k in SHAPE_KEYS if k != "backbone_config"}
    out["backbone_config"] = {"embedding_size": cfg.embedding_size, "hidden_sizes": list(cfg.hidden_sizes),
                              "depths": list(cfg.depths)}
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


@pytest.mark.parametrize("depth", [CUT, {}], ids=["cut", "published"])
def test_the_model_matches_the_reference(depth):
    cfg = M.Mask2FormerConfig(**depth)
    shape = _shape(cfg)
    state = random_state(SEED, shape)
    image = _frame(96, 128)
    with torch.no_grad():
        cls, mask, memory, *masks = _model(state, cfg)(image[None])
    assert cls.shape == (1, 100, 11) and mask.shape == (1, 100, 24, 32) and memory.shape == (1, 12 + 48 + 192, 256)
    levels = [3 * 4, 6 * 8, 12 * 16]
    assert [m.shape for m in masks] == [(1, 100, levels[i % 3]) for i in range(cfg.decoder_layers - 1)]
    assert all(m.dtype == torch.bool for m in masks)
    # the reference fed the port's masks (teacher forcing), then its own
    # threshold against the port's bits where its logits decide them
    want = Reference(state, shape, "cpu").forward(image, [m[0] for m in masks])
    assert _gap(cls[0], want["class_logits"]) <= LOGIT_RTOL
    assert _gap(mask[0], want["mask_logits"]) <= LOGIT_RTOL
    assert _gap(memory[0], want["memory"]) <= LOGIT_RTOL
    for bits, logits in zip(masks, want["attn_logits"]):
        decided = logits.abs() > 1e-4 * logits.abs().max()
        assert torch.equal(bits[0][decided], (logits.sigmoid() < 0.5)[decided])
    # semantic inference at the frame, from the port's own logits (those
    # of random weights mask nearly everything, where a sigmoid turns the
    # logits' absolute rounding into a relative one)
    scores = M.semantic_scores(cls, mask, 96, 128)
    assert scores.shape == (1, 10, 96, 128)
    assert _gap(scores[0], Reference.semantic(cls[0], mask[0], (96, 128))) <= LOGIT_RTOL


def test_the_reference_follows_its_own_masks_when_not_forced():
    cfg = M.Mask2FormerConfig(**CUT)
    shape = _shape(cfg)
    state = random_state(SEED + 1, shape)
    image = _frame(64, 96, 1)
    ref = Reference(state, shape, "cpu")
    own = ref.forward(image)
    assert all(torch.equal(used, logits.sigmoid() < 0.5) for used, logits in zip(own["masks"], own["attn_logits"]))
    with torch.no_grad():
        cls, mask, _, *masks = _model(state, cfg)(image[None])
    forced = ref.forward(image, [m[0] for m in masks])
    assert _gap(cls[0], forced["class_logits"]) <= LOGIT_RTOL


def _locations(shapes, q: int, gen: torch.Generator) -> torch.Tensor:
    """(1, q, 2, L, 4, 2) locations: random ones in and around the map,
    points well outside it, on its edges (the outer pixel centres and the
    border itself) and at exact pixel centres."""
    loc = torch.rand((1, q, 2, len(shapes), 4, 2), generator=gen) * 1.6 - 0.3
    for l, (h, w) in enumerate(shapes):
        loc[0, 0, :, l, 0] = torch.tensor([-0.7, 1.9])  # outside
        loc[0, 1, :, l, 0] = torch.tensor([0.0, 1.0])  # the border
        loc[0, 2, :, l, 0] = torch.tensor([0.5 / w, (h - 0.5) / h])  # outer pixel centres
        loc[0, 3, :, l, 0] = torch.tensor([1.0 - 0.5 / w, 0.5 / h])
        cols = torch.randint(0, w, (q,), generator=gen)
        rows = torch.randint(0, h, (q,), generator=gen)
        loc[0, :, 0, l, 1, 0] = (cols + 0.5) / w  # exact centres
        loc[0, :, 0, l, 1, 1] = (rows + 0.5) / h
        loc[0, 4, :, l, 2] = torch.tensor([-0.5 / w, -0.5 / h])  # one pixel beyond the corner
    return loc


def test_sampling_matches_grid_sample():
    # Deformable DETR's ms_deform_attn_core_pytorch: grid_sample a level
    # (bilinear, zero padding, corners not aligned), then the weighted sum
    shapes = [(3, 5), (6, 7), (1, 2)]
    gen = torch.Generator().manual_seed(3)
    S, M_, D = sum(h * w for h, w in shapes), 2, 8
    value = torch.randn((1, S, M_, D), generator=gen)
    loc = _locations(shapes, 40, gen)
    weights = torch.rand((1, 40, M_, len(shapes), 4), generator=gen)
    got = op.sample(value, shapes, loc, weights)
    sampled = []
    for l, v in enumerate(value.split([h * w for h, w in shapes], dim=1)):
        h, w = shapes[l]
        grid = (2 * loc[:, :, :, l] - 1).transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v.flatten(2).transpose(1, 2).reshape(M_, D, h, w), grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=False))
    w_ = weights.transpose(1, 2).reshape(M_, 1, 40, -1)
    want = (torch.stack(sampled, dim=-2).flatten(-2) * w_).sum(-1).view(M_, D, 40).permute(2, 0, 1)[None]
    torch.testing.assert_close(got, want, rtol=0, atol=SAMPLE_ATOL)
    # a point at a pixel centre samples that pixel
    centre = op.sample(value, shapes[:1], loc[:, :, :, :1, 1:2], torch.ones((1, 40, M_, 1, 1)))
    cols, rows = (loc[0, :, 0, 0, 1, 0] * 5 - 0.5).round().long(), (loc[0, :, 0, 0, 1, 1] * 3 - 0.5).round().long()
    torch.testing.assert_close(centre[0, :, 0], value[0, rows * 5 + cols, 0], rtol=0, atol=SAMPLE_ATOL)


def test_the_wrapper_forms_locations_and_weights_as_published():
    # the op from the linears' outputs against the published MSDeformAttn
    # arithmetic: reference points, offsets over (W, H), softmax over the
    # head's L * P logits
    shapes = [(2, 3), (4, 6), (8, 12)]
    gen = torch.Generator().manual_seed(4)
    S = sum(h * w for h, w in shapes)
    value = torch.randn((1, S, 64), generator=gen)
    offsets = torch.randn((1, S, 8 * 3 * 4 * 2), generator=gen) * 3
    logits = torch.randn((1, S, 8 * 3 * 4), generator=gen)
    got = op.ms_deform_attn(value, offsets, logits, shapes)
    assert got.shape == value.shape and got.dtype == value.dtype
    refs = []
    for h, w in shapes:
        y, x = torch.meshgrid(torch.linspace(0.5, h - 0.5, h), torch.linspace(0.5, w - 0.5, w), indexing="ij")
        refs.append(torch.stack((x.reshape(-1) / w, y.reshape(-1) / h), -1))
    ref_points = torch.cat(refs)
    assert torch.equal(op.reference_points(shapes, "cpu"), ref_points)
    norm = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    loc = ref_points[None, :, None, None, None, :] + offsets.view(1, S, 8, 3, 4, 2) / norm[None, None, None, :, None, :]
    weights = torch.softmax(logits.view(1, S, 8, 12), -1).view(1, S, 8, 3, 4)
    want = op.sample(value.view(1, S, 8, 8), shapes, loc, weights).reshape(1, S, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not op.ms_deform_attn.launches  # the plain version counts no launch


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    shapes = [(1, 2), (2, 3), (2, 4)]
    value = torch.zeros((1, 16, 64), dtype=torch.bfloat16)
    offsets = torch.zeros((1, 16, 8 * 3 * 4 * 2), dtype=torch.bfloat16)
    logits = torch.zeros((1, 16, 8 * 3 * 4), dtype=torch.bfloat16)
    assert op._check(value, offsets, logits, shapes) == (1, 16, 8, 8)
    with pytest.raises(ValueError, match="tokens"):
        op._check(value, offsets, logits, [(1, 2), (2, 3), (2, 3)])
    with pytest.raises(ValueError, match="multiple"):
        op._check(torch.zeros((1, 16, 48), dtype=torch.bfloat16), offsets, logits, shapes)
    with pytest.raises(TypeError, match="bfloat16"):
        op._check(value.float(), offsets, logits, shapes)
    with pytest.raises(ValueError, match="levels"):
        op._check(value, offsets, logits, [(2, 8)])
    with pytest.raises(ValueError, match="contiguous"):
        op._check(value, torch.zeros((1, 192, 16), dtype=torch.bfloat16).transpose(1, 2), logits, shapes)


def test_release_is_the_published_in_place_rule():
    gen = torch.Generator().manual_seed(5)
    blocked = torch.rand((1, 100, 37), generator=gen) < 0.7
    blocked[0, ::9] = True  # rows that mask every key
    blocked[0, 5] = False
    published = blocked.clone()
    published[torch.where(published.sum(-1) == published.shape[-1])] = False
    assert torch.equal(M.release(blocked), ~published)
    assert int(blocked.all(-1).sum()) == 12


class _HostReads(TorchDispatchMode):
    """Records the operators that read a tensor's value on the host (a
    CUDA graph cannot hold them): scalar reads and data-dependent shapes."""

    READS = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "item")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(r in name for r in self.READS) or (name.startswith("index") and any(
                isinstance(a, (list, tuple)) and any(getattr(t, "dtype", None) == torch.bool for t in a)
                for a in args)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_the_forward_reads_nothing_on_the_host():
    cfg = M.Mask2FormerConfig(**CUT)
    model = _model(random_state(SEED + 2, _shape(cfg)), cfg)
    image = _frame(64, 96, 2)
    with torch.no_grad(), _HostReads() as reads:
        out = model(image[None])
        M.semantic_scores(out[0], out[1], 64, 96).argmax(dim=1)
    assert reads.seen == []
    # the published in-place release is such a read
    blocked = out[3].clone()
    with _HostReads() as reads:
        blocked[torch.where(blocked.sum(-1) == blocked.shape[-1])] = False
    assert reads.seen


def test_state_dict_names_and_shapes_are_detectron2s():
    model = M.Mask2Former()
    sd = model.state_dict()
    drawn = random_state(SEED, SHAPE)
    assert list(sd) == list(drawn)
    assert all(sd[k].shape == drawn[k].shape for k in sd)
    assert sum(v.numel() for v in sd.values()) == 44_058_507
    pd, pr = "sem_seg_head.pixel_decoder", "sem_seg_head.predictor"
    for name, shape in (
        ("backbone.stem.conv1.weight", (64, 3, 7, 7)),
        ("backbone.res2.0.conv1.weight", (64, 64, 1, 1)),
        ("backbone.res2.0.shortcut.norm.running_var", (256,)),
        ("backbone.res3.0.conv2.weight", (128, 128, 3, 3)),  # the stride in the 3x3
        ("backbone.res5.2.conv3.weight", (2048, 512, 1, 1)),
        (f"{pd}.input_proj.0.0.weight", (256, 2048, 1, 1)),  # res5 first
        (f"{pd}.input_proj.2.1.weight", (256,)),
        (f"{pd}.transformer.level_embed", (3, 256)),
        (f"{pd}.transformer.encoder.layers.5.self_attn.sampling_offsets.weight", (192, 256)),
        (f"{pd}.transformer.encoder.layers.5.self_attn.attention_weights.weight", (96, 256)),
        (f"{pd}.transformer.encoder.layers.0.linear1.weight", (1024, 256)),
        (f"{pd}.adapter_1.weight", (256, 256, 1, 1)),
        (f"{pd}.layer_1.norm.bias", (256,)),
        (f"{pd}.mask_features.bias", (256,)),
        (f"{pr}.transformer_cross_attention_layers.8.multihead_attn.in_proj_weight", (768, 256)),
        (f"{pr}.transformer_self_attention_layers.0.self_attn.out_proj.weight", (256, 256)),
        (f"{pr}.transformer_ffn_layers.8.linear1.weight", (2048, 256)),
        (f"{pr}.query_feat.weight", (100, 256)),
        (f"{pr}.query_embed.weight", (100, 256)),
        (f"{pr}.level_embed.weight", (3, 256)),
        (f"{pr}.class_embed.weight", (11, 256)),
        (f"{pr}.mask_embed.layers.2.weight", (256, 256)),
    ):
        assert tuple(sd[name].shape) == shape, name
    assert not any("input_proj" in k for k in sd if k.startswith(pr))  # identities at these widths
    assert f"{pr}.transformer_cross_attention_layers.9.norm.weight" not in sd  # DEC_LAYERS 10: 9 layers


def test_the_position_embedding_is_the_published_sine():
    for h, w in ((3, 4), (6, 10)):
        want = Reference.sine(h, w, 128, "cpu").flatten(1).T
        assert torch.equal(M.position_embedding(h, w, 128, "cpu"), want)


def _mask2former_config(h: int = 64, w: int = 128, precision: str = "fp32"):
    cfg = loop.perception_config(w, h, precision)
    return dataclasses.replace(cfg, architecture="mask2former_r50", model_path=None)


def test_segmenter_applies_semantic_inference_at_the_frame(monkeypatch):
    monkeypatch.setattr(M.Mask2FormerConfig, "encoder_layers", 1)
    monkeypatch.setattr(M.Mask2FormerConfig, "decoder_layers", 4)
    state = random_state(SEED + 3, _shape(M.Mask2FormerConfig()))
    seg = TrackSegmenter(_mask2former_config(), state, device="cpu")
    image = _frame(64, 128, 4)
    drivable, semantics, logits = seg._apply(image)
    cls, mask, memory, *masks = logits
    assert cls.shape == (1, 100, 11) and mask.shape == (1, 100, 16, 32) and len(masks) == 3
    scores = M.semantic_scores(cls, mask, 64, 128)
    assert torch.equal(semantics, torch.argmax(scores, dim=1)[0].to(torch.uint8))
    assert torch.equal(drivable, (semantics == 1).to(torch.uint8))
    d2, s2 = seg.segment_drivable_area(image.numpy())
    assert torch.equal(d2, drivable) and torch.equal(s2, semantics)


def test_segmenter_saves_and_loads_its_weights(tmp_path, monkeypatch):
    monkeypatch.setattr(M.Mask2FormerConfig, "encoder_layers", 1)
    monkeypatch.setattr(M.Mask2FormerConfig, "decoder_layers", 4)
    cfg = _mask2former_config()
    seg = TrackSegmenter(cfg, random_state(SEED, _shape(M.Mask2FormerConfig())), device="cpu")
    seg.save_variables(tmp_path / "m2f.pt")
    assert isinstance(torch.load(tmp_path / "m2f.pt", weights_only=True), dict)  # a state dict, no msgpack
    again = TrackSegmenter(dataclasses.replace(cfg, model_path=str(tmp_path / "m2f.pt")), device="cpu")
    for k, v in seg.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    fpn_checkpoint = str(ROOT / "data/models/segmentation/synthetic_fpn.msgpack")
    with pytest.raises(ValueError, match="format"):
        TrackSegmenter(dataclasses.replace(cfg, model_path=fpn_checkpoint), device="cpu")


def test_every_architecture_has_one_entry():
    assert set(ENTRIES) == {"fpn_resnet18", "segformer_b2", "mask2former_r50", "mask2former_swin_l"}
    assert all(callable(getattr(e, f.name)) for e in ENTRIES.values() for f in dataclasses.fields(e))


def test_perceiver_runs_mask2former_and_carries_its_outputs(monkeypatch):
    monkeypatch.setattr(M.Mask2FormerConfig, "encoder_layers", 1)
    monkeypatch.setattr(M.Mask2FormerConfig, "decoder_layers", 4)
    cfg = _mask2former_config(192, 320)
    state = random_state(SEED + 4, _shape(M.Mask2FormerConfig()))
    perc = Perceiver(cfg, state, device="cpu", keep_logits=True)
    image = _frame(192, 320, 5)
    out = perc._pipeline(image)
    eager = perc._run_pipeline(image)
    assert set(out[2]) == set(TRACK_KEYS)
    assert isinstance(out.logits, tuple) and len(out.logits) == 3 + 3
    assert all(torch.equal(a, b) for a, b in zip(out.logits, eager.logits)) and torch.equal(out[0], eager[0])
    # without keep_logits the pipelines hand out none of them
    plain = Perceiver(cfg, state, device="cpu")._pipeline(image)
    assert plain.logits is None and torch.equal(plain[0], out[0])
