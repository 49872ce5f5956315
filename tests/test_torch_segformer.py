"""SegFormer-B2 (``models/segformer.py``) against the plain reference the
benchmark judges the card by (``perfbench/reference/segformer.py``), on
the CPU at small frames, in float32, with the reference's seeded random
weights (``random_state``: every bias, norm parameter and statistic
non-trivial, so that a dropped one shows); the segmenter and the
perceiver built from ``perception.architecture``; the FPN's path as it
was; the published initialisation's statistics."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.config.schema import PerceptionConfig, load_config
from acmpc_tpu_torch.models import segformer as S
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter
from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
from perfbench.reference.segformer import SHAPE_KEYS, SegFormer, random_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the same float32 products and sums as the reference in another order
# (cuDNN-free CPU kernels, fused attention against blocked softmax): the
# rounding of ~20 layers of float32 reductions of up to 3,072 terms,
# relative to the largest logit, stays near 1e-6
LOGIT_RTOL = 1e-5
# one layer's float32 rounding against the same layer computed plainly
LAYER_ATOL = 1e-5
ONE_BLOCK = (1, 1, 1, 1)
SEED = 2**31 + 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shape(cfg: S.SegformerConfig) -> dict:
    return {k: getattr(cfg, k) for k in SHAPE_KEYS}


def _state(seed: int, cfg: S.SegformerConfig | None = None) -> dict:
    return random_state(seed, _shape(cfg or S.SegformerConfig()))


def _model(state: dict, cfg: S.SegformerConfig) -> S.SegformerForSemanticSegmentation:
    model = S.SegformerForSemanticSegmentation(cfg)
    model.load_state_dict(state)
    return model.eval()


def _frame(h: int, w: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, generator=g)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference of the port's (1, h, w, C) logits from
    the reference's (C, h, w), over the reference's largest logit."""
    return float((got[0].permute(2, 0, 1) - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("depths", [ONE_BLOCK, S.SegformerConfig.depths], ids=["one_block", "published"])
def test_logits_match_the_reference(depths):
    cfg = S.SegformerConfig(depths=depths)
    state = _state(SEED, cfg)
    image = _frame(64, 128)
    with torch.no_grad():
        got = _model(state, cfg)((image.float() / 255.0)[None])
    ref = SegFormer(state, _shape(cfg), "cpu")
    assert got.shape == (1, 16, 32, 10) and got.dtype == torch.float32
    assert _gap(got, ref.coarse_logits(image)) <= LOGIT_RTOL
    full = S.to_frame(got, 64, 128)
    assert full.shape == (1, 64, 128, 10)
    assert _gap(full, ref.logits(image)) <= LOGIT_RTOL


@pytest.mark.parametrize("stage", [0, 3], ids=["reduction_8", "reduction_1"])
def test_a_block_matches_the_reference(stage):
    # stage 1 reduces its keys and values by a stride-8 convolution and
    # a LayerNorm; stage 4 attends over every token (R = 1, eight heads)
    cfg = S.SegformerConfig(depths=ONE_BLOCK)
    state = _state(SEED + 1, cfg)
    model = _model(state, cfg)
    layer = model.segformer.encoder.block[stage][0]
    assert hasattr(layer.attention.self, "sr") == (cfg.sr_ratios[stage] > 1)
    h, w, c = 16, 24, cfg.hidden_sizes[stage]
    x = torch.randn(1, h * w, c, generator=torch.Generator().manual_seed(3))
    ref = SegFormer(state, _shape(cfg), "cpu")
    want = ref.block(x[0], f"segformer.encoder.block.{stage}.0", h, w, cfg.num_attention_heads[stage],
                     cfg.sr_ratios[stage])
    with torch.no_grad():
        got = layer(x, h, w)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=LAYER_ATOL)


def test_mix_ffn_is_linear_depthwise_gelu_linear():
    cfg = S.SegformerConfig(depths=ONE_BLOCK)
    state = _state(SEED + 2, cfg)
    mlp = _model(state, cfg).segformer.encoder.block[1][0].mlp
    h, w, c = 8, 12, cfg.hidden_sizes[1]
    x = torch.randn(h * w, c, generator=torch.Generator().manual_seed(4))
    p = "segformer.encoder.block.1.0.mlp."
    hidden = F.linear(x, state[p + "dense1.weight"], state[p + "dense1.bias"])
    assert hidden.shape[-1] == 4 * c
    maps = hidden.T.reshape(1, 4 * c, h, w)
    maps = F.conv2d(maps, state[p + "dwconv.dwconv.weight"], state[p + "dwconv.dwconv.bias"], padding=1, groups=4 * c)
    want = F.linear(F.gelu(maps[0].flatten(1).T), state[p + "dense2.weight"], state[p + "dense2.bias"])
    with torch.no_grad():
        got = mlp(x[None], h, w)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=LAYER_ATOL)


def test_the_head_concatenates_deepest_first():
    # only stage 4's features non-zero: the fuse reads them through its
    # first 768 input channels, as the published head's concatenation of
    # the stages in reverse order puts them
    cfg = S.SegformerConfig(depths=ONE_BLOCK)
    state = _state(SEED + 3, cfg)
    head = _model(state, cfg).decode_head
    g = torch.Generator().manual_seed(5)
    sizes = [(8, 16), (4, 8), (2, 4), (1, 2)]
    feats = [torch.zeros(1, c, *hw) for c, hw in zip(cfg.hidden_sizes, sizes)]
    feats[3] = torch.randn(1, cfg.hidden_sizes[3], 1, 2, generator=g)
    d = cfg.decoder_hidden_size
    lin = lambda i, x: F.linear(x[0].flatten(1).T, state[f"decode_head.linear_c.{i}.proj.weight"],  # noqa: E731
                                state[f"decode_head.linear_c.{i}.proj.bias"]).T.reshape(1, d, *x.shape[-2:])
    parts = [F.interpolate(lin(i, f), size=sizes[0], mode="bilinear", align_corners=False) for i, f in enumerate(feats)]
    fuse = state["decode_head.linear_fuse.weight"]
    assert fuse.shape == (d, 4 * d, 1, 1)
    mixed = F.conv2d(torch.cat(parts[::-1], dim=1), fuse)
    bn = "decode_head.batch_norm."
    mixed = F.batch_norm(mixed, state[bn + "running_mean"], state[bn + "running_var"], state[bn + "weight"],
                         state[bn + "bias"], eps=1e-5)
    want = F.conv2d(F.relu(mixed), state["decode_head.classifier.weight"], state["decode_head.classifier.bias"])
    shallow_first = F.conv2d(torch.cat(parts, dim=1), fuse)
    with torch.no_grad():
        got = head(feats)
    torch.testing.assert_close(got, want, rtol=0, atol=LAYER_ATOL)
    assert not torch.allclose(shallow_first, F.conv2d(torch.cat(parts[::-1], dim=1), fuse))


def test_seeded_initialisation_repeats_with_the_published_statistics():
    a, b, c = S.init_state_dict(SEED), S.init_state_dict(SEED), S.init_state_dict(SEED + 1)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decode_head.linear_fuse.weight"], c["decode_head.linear_fuse.weight"])
    assert sum(v.numel() for k, v in a.items() if "running" not in k and "num_batches" not in k) == 27_354_314
    # Linear: a normal of deviation 0.02 (truncated at +-2), biases 0
    w = a["segformer.encoder.block.3.0.mlp.dense1.weight"]  # 2048 x 512
    assert w.std().item() == pytest.approx(0.02, rel=0.01) and abs(w.mean().item()) < 1e-4
    assert not a["segformer.encoder.block.3.0.mlp.dense1.bias"].any()
    # convolutions: deviation sqrt(2 / fan_out), fan_out = k * k * out / groups
    for name, fan_out in (("decode_head.linear_fuse.weight", 768), ("segformer.encoder.block.0.0.mlp.dwconv.dwconv.weight", 9),
                          ("segformer.encoder.block.0.0.attention.self.sr.weight", 64 * 64),
                          ("segformer.encoder.patch_embeddings.0.proj.weight", 7 * 7 * 64)):
        assert a[name].std().item() == pytest.approx((2.0 / fan_out) ** 0.5, rel=0.03), name
    assert not a["segformer.encoder.patch_embeddings.0.proj.bias"].any()
    # LayerNorm and BatchNorm: weight 1, bias 0; statistics 0 and 1
    for k, v in a.items():
        if "layer_norm" in k or k.startswith("decode_head.batch_norm.") and "num_batches" not in k:
            want = 1.0 if k.endswith(("weight", "running_var")) else 0.0
            assert torch.all(v == want), k


def _segformer_config(h: int = 64, w: int = 128, precision: str = "fp32") -> PerceptionConfig:
    cfg = loop.perception_config(w, h, precision)
    return dataclasses.replace(cfg, architecture="segformer_b2", model_path=None)


def test_apply_hands_out_the_logits_its_mask_reads():
    # the model's own logits at stage 1's grid; the mask is their argmax
    # resized to the frame
    seg = TrackSegmenter(_segformer_config(), _state(SEED), device="cpu")
    image = _frame(64, 128, 1)
    drivable, semantics, logits = seg._apply(image)
    assert logits.shape == (1, 16, 32, 10) and logits.dtype == torch.float32
    assert torch.equal(semantics, torch.argmax(S.to_frame(logits, 64, 128), dim=-1)[0].to(torch.uint8))
    assert torch.equal(drivable, (semantics == 1).to(torch.uint8))
    d2, s2 = seg.segment_drivable_area(image.numpy())
    assert torch.equal(d2, drivable) and torch.equal(s2, semantics)


def test_segmenter_saves_and_loads_its_weights(tmp_path):
    cfg = _segformer_config()
    seg = TrackSegmenter(cfg, _state(SEED), device="cpu")
    seg.save_variables(tmp_path / "segformer.pt")
    again = TrackSegmenter(dataclasses.replace(cfg, model_path=str(tmp_path / "segformer.pt")), device="cpu")
    for k, v in seg.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="architecture"):
        TrackSegmenter(dataclasses.replace(cfg, architecture="unet"), S.init_state_dict(SEED), device="cpu")
    with pytest.raises(ValueError, match="format"):
        TrackSegmenter(dataclasses.replace(cfg, model_path=str(ROOT / "data/models/segmentation/synthetic_fpn.msgpack")),
                       device="cpu")


def test_perceiver_runs_segformer_and_carries_its_logits():
    cfg = _segformer_config(192, 320)
    state = _state(SEED)
    perc = Perceiver(cfg, state, device="cpu", keep_logits=True)
    image = _frame(192, 320, 2)
    out = perc._pipeline(image)
    eager = perc._run_pipeline(image)
    drivable, semantics, tracks = out
    assert set(tracks) == set(TRACK_KEYS)
    assert torch.equal(out.logits, eager.logits) and torch.equal(drivable, eager[0])
    want = SegFormer(state, _shape(S.SegformerConfig()), "cpu").coarse_logits(image)
    assert _gap(out.logits, want) <= LOGIT_RTOL
    # without keep_logits the pipelines hand out no logits; the rest alike
    plain = Perceiver(cfg, state, device="cpu")._pipeline(image)
    assert plain.logits is None and torch.equal(plain[0], drivable)
    assert set(perc.perceive(image.numpy())) == {"drivable", "semantics", "centreline", "left", "right", "left_raw",
                                                  "left_raw_mask", "right_raw", "right_raw_mask"}


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_every_track_config_runs_the_fpn(path):
    assert load_config(path).perception.architecture == "fpn_resnet18"


def test_fpn_perceiver_output_is_the_fpn_pipeline_as_it_was():
    # the FPN pipeline before the SegFormer: the model's argmax, classes
    # above 1 zeroed, the extraction of that mask; bit for bit
    cfg = loop.perception_config(320, 192, "fp32")
    perc = Perceiver(cfg, device="cpu")
    assert perc.segmenter.architecture == "fpn_resnet18"
    frame = _frame(192, 320, 3)
    with torch.no_grad():
        logits = perc.segmenter.model((frame.float() / 255.0)[None])
    semantics = torch.argmax(logits, dim=-1)[0].to(torch.uint8)
    drivable = torch.where(semantics > 1, 0, semantics).to(torch.uint8)
    tracks = perc.extractor.extract(drivable)
    kept = Perceiver(cfg, device="cpu", keep_logits=True)
    outs = {"eager": perc._run_pipeline(frame), "pipeline": perc._pipeline(frame), "kept": kept._pipeline(frame)}
    for out in outs.values():
        assert torch.equal(out[0], drivable) and torch.equal(out[1], semantics)
        assert set(out[2]) == set(tracks)
        for k in tracks:
            assert torch.equal(out[2][k], tracks[k]), k
    # the logits only where asked for: the served pipeline neither keeps nor copies them
    assert torch.equal(outs["eager"].logits, logits) and torch.equal(outs["kept"].logits, logits)
    assert outs["pipeline"].logits is None
    got = perc.perceive(np.ascontiguousarray(frame.numpy()))
    host = torch.as_tensor(perc._encode_decode_image(frame.numpy()))
    assert torch.equal(got["drivable"], perc._run_pipeline(host)[0])
