"""The SegFormer cell (``monza_racing_segformer_b2.perceive_b1``) on the
CPU at a small frame: a sound run is correct, with a real share of each
frame drivable and every fit judged; a fault planted in the SegFormer
under the timed path (an attention, a norm's or a statistic's dropped
parameter, a mask shifted against its logits) is not, nor is the float8 control;
and the SegFormer's work against a hand count."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch
import torch.nn.functional as F

from perfbench import harness
from perfbench.metrics._segformer_flops import segformer_flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 1013
CELL = "monza_racing_segformer_b2.perceive_b1"


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The benchmark with the camera at 320x192 and a pool of 2 frames,
    both judged."""
    root = tmp_path_factory.mktemp("segformer_bench")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = harness.load_manifest(ROOT)
    for entry in manifest["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        c["agent"]["perception"].update(image_width=320, image_height=192, n_rows_to_remove_bonnet=160,
                                        n_polyfit_points=200)
        (root / entry["file"]).write_text(json.dumps(c))
    path = root / "perfbench" / "traffic" / "perceive_b1.json"
    t = json.loads(path.read_text())
    t.update(pool=2, clips=2, check_frames=2, warm_requests=1)
    path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    torch.set_num_threads(4)
    return root


def _run(root, hook=None, control=False):
    return harness.run(CELL, SEED, 1.0, False, root=root, require_card=False, device=torch.device("cpu"),
                       cell_hook=hook, control=control)


def test_a_sound_run_is_correct_and_the_control_is_not(small_root):
    cells = []
    out, checks, control = _run(small_root, cells.append, control=True)
    assert out["correct"], checks
    assert [name for name, _, _ in checks] == ["logit_gap", "mask_gap", "tracks_gap"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert not harness.judged(control), control
    assert {n: v for n, v, _ in control}["logit_gap"] > {n: lim for n, _, lim in checks}["logit_gap"]
    # the fitted classifier: the asphalt drivable, every fit determined
    cell = cells[0]
    for got in cell.kept.values():
        assert 0.2 < got["drivable"].float().mean() < 0.8
    assert cell.fits_judged == [3] * len(cell.kept)


def _model(cell):
    return cell.perceiver.segmenter.model


def _scale_attention(cell):
    for layer in _model(cell).segformer.encoder.block[1]:
        layer.attention.register_forward_hook(lambda module, args, out: out * 1.5)


@torch.no_grad()
def _drop_norm_biases(cell):
    for layer in _model(cell).segformer.encoder.block[1]:
        layer.layer_norm_1.bias.zero_()
        layer.layer_norm_2.bias.zero_()


@torch.no_grad()
def _drop_norm_weights(cell):
    for layer in _model(cell).segformer.encoder.block[1]:
        layer.layer_norm_1.weight.fill_(1.0)
        layer.layer_norm_2.weight.fill_(1.0)


@torch.no_grad()
def _drop_batch_norm_affine(cell):
    bn = _model(cell).decode_head.batch_norm
    bn.weight.fill_(1.0)
    bn.bias.zero_()


@torch.no_grad()
def _drop_running_mean(cell):
    _model(cell).decode_head.batch_norm.running_mean.zero_()


@torch.no_grad()
def _drop_linear_biases(cell):
    for layer in _model(cell).segformer.encoder.block[0]:
        for linear in (layer.attention.self.query, layer.attention.self.key, layer.attention.self.value,
                       layer.attention.output.dense, layer.mlp.dense1, layer.mlp.dense2):
            linear.bias.zero_()


def _resize_shifted(cell):
    # the logits resized to the frame a stage-1 cell (4 pixels) off
    seg = cell.perceiver.segmenter

    def apply(image):
        logits = seg.model((image.to(seg.dtype) / 255.0)[None])
        full = F.interpolate(logits.permute(0, 3, 1, 2).float(), size=image.shape[:2], mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)
        semantics = torch.argmax(torch.roll(full, 4, dims=2), dim=-1)[0].to(torch.uint8)
        return torch.where(semantics > 1, 0, semantics).to(torch.uint8), semantics, logits

    seg._apply = apply


FAULTS = [
    (_scale_attention, "logit_gap"),
    (_drop_norm_biases, "logit_gap"),
    (_drop_norm_weights, "logit_gap"),
    (_drop_batch_norm_affine, "logit_gap"),
    (_drop_running_mean, "logit_gap"),
    (_drop_linear_biases, "logit_gap"),
    (_resize_shifted, "mask_gap"),
]


@pytest.mark.parametrize("fault, caught_by", FAULTS, ids=lambda v: getattr(v, "__name__", v).strip("_"))
def test_a_planted_fault_is_not_correct(small_root, fault, caught_by):
    out, checks = _run(small_root, fault)
    assert not out["correct"]
    assert dict((n, v > lim) for n, v, lim in checks)[caught_by], checks


def test_a_frame_the_window_never_judged_is_not_correct(small_root):
    def hook(cell):
        cell.check_frames.add(len(cell.pool))  # a frame outside the pool

    out, checks = _run(small_root, hook)
    assert not out["correct"], checks


def test_segformer_flops_by_hand():
    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_segformer_b2.json").read_text())
    # 1280x736: stages of 184x320, 92x160, 46x80, 23x40 tokens; the keys
    # reduced to 23x40 = 920 at every stage
    t = [58_880, 14_720, 3_680, 920]
    c = [64, 128, 320, 512]
    attention = 4 * 920 * (3 * t[0] * c[0] + 4 * t[1] * c[1] + 6 * t[2] * c[2] + 3 * t[3] * c[3])
    fuse = 2 * t[0] * 3072 * 768
    embed = 2 * (t[0] * 64 * 3 * 49 + t[1] * 128 * 64 * 9 + t[2] * 320 * 128 * 9 + t[3] * 512 * 320 * 9)
    blocks = 0
    for d, ti, ci, r in zip((3, 4, 6, 3), t, c, (8, 4, 2, 1)):
        kv = 920
        per = 2 * ti * ci * ci * 2 + 2 * kv * ci * ci * 2 + (2 * kv * ci * ci * r * r if r > 1 else 0)  # Q, out, K, V, sr
        per += 2 * 2 * ti * ci * 4 * ci + 2 * ti * 4 * ci * 9  # the Mix-FFN
        blocks += d * per
    decoder = 2 * 768 * sum(ti * ci for ti, ci in zip(t, c)) + fuse + 2 * t[0] * 768 * 10
    got = segformer_flops(736, 1280, shape)
    assert got["attention"] == pytest.approx(attention, rel=1e-12)
    assert got["attention"] == pytest.approx(100.54e9, rel=1e-3)
    assert got["fuse"] == fuse == pytest.approx(277.83e9, rel=1e-4)
    assert got["encoder"] == pytest.approx(embed + blocks + attention, rel=1e-12)
    assert got["decoder"] == pytest.approx(decoder, rel=1e-12)
    assert got["total"] == pytest.approx(507.95e9, rel=1e-4)
    # Q, K, V and the output in bf16, each moved once
    assert got["attention_bytes"] == pytest.approx(
        2 * sum(d * (2 * ti * ci + 2 * 920 * ci) for d, ti, ci in zip((3, 4, 6, 3), t, c)), rel=1e-12)
