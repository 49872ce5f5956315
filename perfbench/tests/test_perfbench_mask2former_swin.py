"""The Mask2Former-Swin cell (``monza_racing_mask2former_swin_l.
perceive_swin_b1``) on the CPU at a small Swin (embed 32, depths
2/2/2/2, heads 1/2/4/8, window 7) and a 320x192 frame, whose grids pad
at every stage: a sound run is correct, with a real share of each frame
drivable and every fit judged; the float8 control is not, nor is a
fault planted in the window attention under the timed path (the shift
mask dropped, the padding's keys skipped, the bias table read
transposed, a block's output left where the roll put it); the manifest
takes the cell as new entries and files; Swin's work against a hand
count."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest
import torch

from perfbench import harness
from perfbench.metrics._swin_flops import swin_flops

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 2026
CELL = "monza_racing_mask2former_swin_l.perceive_swin_b1"
CONFIG = "monza_racing_mask2former_swin_l"
CHECKS = ["class_gap", "mask_logit_gap", "encoder_gap", "attn_mask_gap", "mask_gap", "tracks_gap", "backbone_gap"]
SMALL = {"embed_dim": 32, "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8], "window_size": 7}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The benchmark with the camera at 320x192, a pool of 2 frames, both
    judged, and the small Swin in the configuration."""
    root = tmp_path_factory.mktemp("swin_bench")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = harness.load_manifest(ROOT)
    for entry in manifest["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        c["agent"]["perception"].update(image_width=320, image_height=192, n_rows_to_remove_bonnet=160,
                                        n_polyfit_points=200)
        if entry["name"] == CONFIG:
            c["backbone_config"].update(SMALL)
        (root / entry["file"]).write_text(json.dumps(c))
    path = root / "perfbench" / "traffic" / "perceive_swin_b1.json"
    t = json.loads(path.read_text())
    t.update(pool=2, clips=2, check_frames=2, warm_requests=1)
    path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    torch.set_num_threads(4)
    return root


@pytest.fixture
def small_swin(monkeypatch):
    """The program's Swin entry at the small widths."""
    from acmpc_tpu_torch.models.swin import SwinConfig
    from acmpc_tpu_torch.perception import segmentation

    monkeypatch.setattr(segmentation, "SwinConfig", lambda: SwinConfig(**SMALL))


def _run(root, hook=None, control=False):
    return harness.run(CELL, SEED, 1.0, False, root=root, require_card=False, device=torch.device("cpu"),
                       cell_hook=hook, control=control)


def test_a_sound_run_is_correct_and_the_control_is_not(small_root, small_swin):
    cells = []
    out, checks, control = _run(small_root, cells.append, control=True)
    assert out["correct"], checks
    assert [name for name, _, _ in checks] == CHECKS
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert not harness.judged(control), control
    cell = cells[0]
    for got in cell.kept.values():
        assert 0.2 < got["drivable"].float().mean() < 0.8
        assert [f.shape[1] for f in got["features"]] == [32, 64, 128, 256]
    assert cell.fits_judged == [3] * len(cell.kept)


def faulty_attention(fault: str):
    """The plain window attention (``ops/window_attention``) with one
    fault: ``no_shift_mask`` (the -100 between the rolled map's regions
    dropped), ``padded_keys_skipped`` (the padding's keys masked out),
    ``table_transposed`` (the bias of the pair (j, i) for (i, j)) or
    ``output_shifted`` (the output left in the rolled map)."""
    from acmpc_tpu_torch.ops import window_attention as op

    def attention(qkv, bias, table, heads, window, shift):
        n, h, w, c3 = qkv.shape
        c = c3 // 3
        hp, wp = -(-h // window) * window, -(-w // window) * window
        x = bias.expand(n, hp, wp, c3).clone()
        x[:, :h, :w] = qkv
        real = torch.zeros((n, hp, wp, 1), dtype=qkv.dtype, device=qkv.device)
        real[:, :h, :w] = 1
        if shift:
            x, real = (torch.roll(t, shifts=(-shift, -shift), dims=(1, 2)) for t in (x, real))
        windows = op.partition(x, window).view(-1, window * window, c3)
        b_, tokens, _ = windows.shape
        q, k, v = windows.reshape(b_, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
        index = op.relative_position_index(window, qkv.device)
        if fault == "table_transposed":
            index = index.T
        attn = attn + table[index.reshape(-1)].view(tokens, tokens, heads).permute(2, 0, 1)[None]
        if shift and fault != "no_shift_mask":
            mask = op.shift_mask(hp, wp, window, shift, qkv.device).to(attn.dtype)
            attn = (attn.view(n, -1, heads, tokens, tokens) + mask[None, :, None]).view(b_, heads, tokens, tokens)
        if fault == "padded_keys_skipped":
            keys = op.partition(real, window).view(b_, 1, 1, tokens) > 0
            attn = attn.masked_fill(~keys, float("-inf"))
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(b_, tokens, c)
        x = op.reverse(out.view(-1, window, window, c), window, hp, wp)
        if shift and fault != "output_shifted":
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        return x[:, :h, :w].contiguous()

    return attention


FAULTS = ["no_shift_mask", "padded_keys_skipped", "table_transposed", "output_shifted"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(small_root, small_swin, monkeypatch, fault):
    # planted as the cell sets up, so the segmenter's forward (eager here,
    # captured on the card) runs it in place of the window attention
    from acmpc_tpu_torch.models import swin

    monkeypatch.setattr(swin, "window_attention", faulty_attention(fault))
    out, checks = _run(small_root)
    assert not out["correct"]
    assert dict((n, not v <= lim) for n, v, lim in checks)["backbone_gap"], checks


def test_the_fault_free_composition_is_the_plain_version():
    # the planted faults' composition, with no fault, is the op's plain
    # version bit for bit: each fault is the one change it names
    from acmpc_tpu_torch.ops import window_attention as op

    g = torch.Generator().manual_seed(3)
    qkv, bias, table = torch.randn((2, 9, 16, 192), generator=g), torch.randn(192, generator=g), \
        torch.randn((169, 2), generator=g)
    for shift in (0, 3):
        want = op.window_attention_reference(qkv, bias, table, 2, 7, shift)
        assert torch.equal(faulty_attention("none")(qkv, bias, table, 2, 7, shift), want)
        for fault in FAULTS:
            got = faulty_attention(fault)(qkv, bias, table, 2, 7, shift)
            assert not torch.equal(got, want) or (shift == 0 and fault in ("no_shift_mask", "output_shifted"))


def test_the_manifest_takes_the_cell_as_new_entries_and_files():
    manifest = harness.load_manifest(ROOT)
    assert CONFIG in [c["name"] for c in manifest["configs"]]
    assert CELL in [w["name"] for w in manifest["workloads"]]
    per_layer = [m["name"] for m in manifest["per_layer"]]
    assert {"window_attention_roofline", "step_mfu.mask2former_swin"} <= set(per_layer)
    files = harness.cell_files(manifest, CELL, ROOT)
    assert files["driver"].name == "perceive_m2f_swin.py" and files["cell"]["chips"] == 1
    assert files["config"]["agent"]["perception"]["architecture"] == "mask2former_swin_l"
    assert {m["name"] for _, m, _ in files["metrics"]} == {
        "latency_ms_p50", "latency_ms_p95", "setup_s", "perception_ms", "chain_edges_roofline", "device_idle.b1",
        "window_attention_roofline", "step_mfu.mask2former_swin"}
    assert all(path.exists() for _, _, path in files["metrics"])
    # not the R50 cell's sampling counts: their shapes are a ResNet's
    for m in manifest["per_layer"]:
        if m["name"] in ("ms_deform_attn_roofline", "step_mfu.mask2former"):
            assert CELL not in m["workloads"]


def test_swin_flops_by_hand():
    shape = json.loads((ROOT / "perfbench" / "configs" / f"{CONFIG}.json").read_text())
    # 64x96: stages 16x24 (pads to 24x24), 8x12 (12x12), 4x6 (12x12), 2x3 (12x12), windows of 12
    grids = [(16, 24), (8, 12), (4, 6), (2, 3)]
    padded = [24 * 24, 144, 144, 144]
    widths, depths = [192, 384, 768, 1536], [2, 2, 18, 2]
    backbone = 2 * 16 * 24 * 192 * 3 * 16
    attention = 0
    for i, ((h, w), tp, c, d) in enumerate(zip(grids, padded, widths, depths)):
        t = h * w
        if i:
            backbone += 2 * t * 4 * (c // 2) * c
        backbone += d * (2 * tp * c * 3 * c + 2 * tp * c * c + 2 * 2 * tp * 144 * c + 2 * t * c * 4 * c * 2)
        attention += d * 2 * 2 * t * 144 * c
    got = swin_flops(64, 96, shape)
    assert got["backbone"] == pytest.approx(backbone, rel=1e-12)
    assert got["attention"] == pytest.approx(attention, rel=1e-12)
    assert got["attention_bytes"] == pytest.approx(sum(d * 2 * h * w * 4 * c for (h, w), c, d in
                                                       zip(grids, widths, depths)), rel=1e-12)
    # at the agent's frame: 1.376 TFLOP of backbone, 1.69 a frame; the
    # window attention's least 700.9 MB and 50.5 GFLOP
    full = swin_flops(736, 1280, shape)
    assert full["backbone"] == pytest.approx(1.3763e12, rel=1e-4)
    assert full["total"] == pytest.approx(1.6897e12, rel=1e-4)
    assert full["attention_bytes"] == pytest.approx(700.9e6, rel=1e-4)
    assert full["attention"] == pytest.approx(50.47e9, rel=1e-3)
