"""The Mask2Former cell (``monza_racing_mask2former_r50.perceive_m2f_b1``)
on the CPU at small frames: a sound run is correct, with a real share
of each frame drivable, every fit judged and some attention rows
released; a fault planted under the timed path (the level embedding
dropped, bf16 sampling locations, the masked-row release skipped, a
decoder layer skipped, a mask shifted against its logits) is not, nor
is the float8 control; and Mask2Former's work against a hand count."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch

from perfbench import harness
from perfbench.metrics._mask2former_flops import mask2former_flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 2024
CELL = "monza_racing_mask2former_r50.perceive_m2f_b1"
CHECKS = ["class_gap", "mask_logit_gap", "encoder_gap", "attn_mask_gap", "mask_gap", "tracks_gap"]


def _root(tmp_path_factory, width: int, height: int):
    """The benchmark with the camera at width x height and a pool of 2
    frames, both judged."""
    root = tmp_path_factory.mktemp(f"mask2former_bench_{width}")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = harness.load_manifest(ROOT)
    for entry in manifest["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        c["agent"]["perception"].update(image_width=width, image_height=height,
                                        n_rows_to_remove_bonnet=height * 5 // 6, n_polyfit_points=200)
        (root / entry["file"]).write_text(json.dumps(c))
    path = root / "perfbench" / "traffic" / "perceive_m2f_b1.json"
    t = json.loads(path.read_text())
    t.update(pool=2, clips=2, check_frames=2, warm_requests=1)
    path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    torch.set_num_threads(4)
    return root


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return _root(tmp_path_factory, 320, 192)


@pytest.fixture(scope="module")
def wide_root(tmp_path_factory):
    # the 1/8 level 120 columns wide: a bf16 location there is off by up
    # to a quarter of a pixel (a third at the agent's 1280), which the
    # encoder's output shows; at 320 (40 columns) the encoder's own bf16
    # rounding hides it
    return _root(tmp_path_factory, 960, 544)


def _run(root, hook=None, control=False):
    return harness.run(CELL, SEED, 1.0, False, root=root, require_card=False, device=torch.device("cpu"),
                       cell_hook=hook, control=control)


def test_a_sound_run_is_correct_and_the_control_is_not(small_root):
    from acmpc_tpu_torch.models.mask2former import release

    cells = []
    out, checks, control = _run(small_root, cells.append, control=True)
    assert out["correct"], checks
    assert [name for name, _, _ in checks] == CHECKS
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert not harness.judged(control), control
    # the fitted heads: the asphalt drivable, every fit determined, and
    # rows that mask every key (which the release planted below skips)
    cell = cells[0]
    released = 0
    for got in cell.kept.values():
        assert 0.2 < got["drivable"].float().mean() < 0.8
        released += sum(int((release(m) & m).any(-1).sum()) for m in got["logits"][3:])
    assert cell.fits_judged == [3] * len(cell.kept)
    assert released > 0


def _model(cell):
    return cell.perceiver.segmenter.model


@torch.no_grad()
def _drop_level_embedding(cell):
    _model(cell).sem_seg_head.pixel_decoder.transformer.level_embed.zero_()


def _bf16_locations(cell):
    from acmpc_tpu_torch.ops import ms_deform_attn as op

    exact = op.sampling_locations
    cell.undo = lambda: setattr(op, "sampling_locations", exact)
    op.sampling_locations = lambda offsets, shapes: exact(offsets, shapes).bfloat16().float()


def _skip_release(cell):
    from acmpc_tpu_torch.models import mask2former as m2f

    published = m2f.release
    cell.undo = lambda: setattr(m2f, "release", published)
    m2f.release = lambda blocked: ~blocked


def _skip_a_decoder_layer(cell):
    predictor = _model(cell).sem_seg_head.predictor
    for layers in (predictor.transformer_cross_attention_layers, predictor.transformer_self_attention_layers,
                   predictor.transformer_ffn_layers):
        layers[4].register_forward_hook(lambda module, args, out: args[0])


def _mask_shifted(cell):
    # the class map a quarter-grid cell (4 pixels) off its scores
    seg = cell.perceiver.segmenter
    apply = seg._apply

    def shifted(image):
        drivable, semantics, logits = apply(image)
        return torch.roll(drivable, 4, dims=1), torch.roll(semantics, 4, dims=1), logits

    seg._apply = shifted


FAULTS = [
    (_drop_level_embedding, "class_gap", "small_root"),
    (_bf16_locations, "encoder_gap", "wide_root"),
    (_skip_release, "class_gap", "small_root"),
    (_skip_a_decoder_layer, "class_gap", "small_root"),
    (_mask_shifted, "mask_gap", "small_root"),
]


@pytest.mark.parametrize("fault, caught_by, root", FAULTS, ids=lambda v: getattr(v, "__name__", v).strip("_"))
def test_a_planted_fault_is_not_correct(request, fault, caught_by, root):
    cells = []

    def hook(cell):
        cells.append(cell)
        fault(cell)

    try:
        out, checks = _run(request.getfixturevalue(root), hook)
    finally:
        for cell in cells:
            getattr(cell, "undo", lambda: None)()
    assert not out["correct"]
    assert dict((n, not v <= lim) for n, v, lim in checks)[caught_by], checks


def test_a_frame_the_window_never_judged_is_not_correct(small_root):
    def hook(cell):
        cell.check_frames.add(len(cell.pool))  # a frame outside the pool

    out, checks = _run(small_root, hook)
    assert not out["correct"], checks


def test_the_manifest_takes_the_cell_as_new_entries_and_files():
    manifest = harness.load_manifest(ROOT)
    assert manifest["configs"][-1]["name"] == "monza_racing_mask2former_r50"
    assert manifest["workloads"][-1]["name"] == CELL
    assert [m["name"] for m in manifest["per_layer"][-2:]] == ["ms_deform_attn_roofline", "step_mfu.mask2former"]
    files = harness.cell_files(manifest, CELL, ROOT)
    assert files["driver"].name == "perceive_m2f.py" and files["cell"]["chips"] == 1
    assert [m["name"] for _, m, _ in files["metrics"]] == [
        "latency_ms_p50", "latency_ms_p95", "setup_s", "perception_ms", "chain_edges_roofline", "device_idle.b1",
        "ms_deform_attn_roofline", "step_mfu.mask2former"]
    # the cell appended to the lists of the metrics it shares, last
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            assert m["workloads"][-1] == CELL, m["name"]


def test_mask2former_flops_by_hand():
    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_r50.json").read_text())
    # 64x96: res2 16x24 (384), res3 8x12 (96), res4 4x6 (24), res5 2x3 (6)
    t2, t3, t4, t5 = 384, 96, 24, 6
    stem = 2 * 32 * 48 * 64 * 3 * 49

    def bottleneck(t_in, t_out, cin, inner, cout, shortcut):
        return 2 * (t_in * cin * inner + t_out * inner * inner * 9 + t_out * inner * cout
                    + (t_out * cin * cout if shortcut else 0))

    backbone = stem
    for t_in, t_out, cin, inner, cout, depth in ((t2, t2, 64, 64, 256, 3), (t2, t3, 256, 128, 512, 4),
                                                 (t3, t4, 512, 256, 1024, 6), (t4, t5, 1024, 512, 2048, 3)):
        backbone += bottleneck(t_in, t_out, cin, inner, cout, True)
        backbone += (depth - 1) * bottleneck(t_out, t_out, cout, inner, cout, False)
    S = t3 + t4 + t5
    proj = 2 * 256 * (t3 * 512 + t4 * 1024 + t5 * 2048)
    layer = 2 * S * 256 * (192 + 96 + 256 + 256 + 2 * 1024)
    sampling = S * 8 * 12 * 32 * 9
    fpn = 2 * t2 * 256 * 256 * (1 + 9 + 1)
    heads = 10 * (2 * 100 * 256 * (11 + 256 * 3) + 2 * 100 * 256 * t2)
    keys = [t5, t4, t3] * 3
    decoder = sum(2 * 256 * 256 * (100 + 2 * k) + 2 * 2 * 100 * k * 256 + 2 * 100 * 256 * 256 for k in keys)
    decoder += 9 * (2 * 2 * 100 * 256 * 256 + 2 * 100 * 256 * 256 * 2 + 2 * 2 * 100 * 100 * 256
                    + 2 * 2 * 100 * 256 * 2048)
    semantic = 2 * 10 * 100 * 64 * 96
    got = mask2former_flops(64, 96, shape)
    assert got["backbone"] == pytest.approx(backbone, rel=1e-12)
    assert got["pixel_decoder"] == pytest.approx(proj + 6 * layer + fpn, rel=1e-12)
    assert got["sampling"] == pytest.approx(6 * sampling, rel=1e-12)
    assert got["decoder"] == pytest.approx(heads + decoder, rel=1e-12)
    assert got["semantic"] == pytest.approx(semantic, rel=1e-12)
    assert got["total"] == pytest.approx(backbone + proj + 6 * layer + fpn + heads + decoder + semantic, rel=1e-12)
    # a layer's sampling: the value read once, the offsets and logits as
    # the linears give them (bf16), the output written once
    assert got["sampling_bytes"] == pytest.approx(6 * 2 * S * (256 + 192 + 96 + 256), rel=1e-12)
    # at the agent's frame, ~469 GFLOP a frame
    full = mask2former_flops(736, 1280, shape)
    assert 400e9 < full["total"] < 520e9
