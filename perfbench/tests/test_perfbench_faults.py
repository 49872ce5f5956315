"""Each cell's run on the CPU at a small size, with the timed path broken
underneath: ``correct`` has to come out false for every fault the cell
can have (a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced), and true unbroken.
The control (the reference in the program's place, one precision below)
has to come out not correct too, at the configured horizons. The
harness's look for a card is skipped; the rest of a run is driven as on
the card."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 977


def _cut(tmp_path_factory, horizon):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perfbench", root / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = harness.load_manifest(ROOT)
    for entry in manifest["configs"]:
        c = json.loads((ROOT / entry["file"]).read_text())
        if horizon:
            c["agent"][c["block"]]["control"]["horizon"] = horizon
        c["agent"]["perception"].update(image_width=320, image_height=192, n_rows_to_remove_bonnet=160,
                                        n_polyfit_points=200)
        (root / entry["file"]).write_text(json.dumps(c))
    for path in (root / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in (("batch", 8), ("check_steps", 3), ("pool", 8), ("clips", 2),
                                    ("check_frames", 2), ("control_steps", 8), ("control_lanes", 8)) if k in t})
        path.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    torch.set_num_threads(4)
    return root


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A copy of the benchmark with the controllers cut to short horizons,
    the camera to 320x192, the sweep to 8 cars and a few judged steps."""
    return _cut(tmp_path_factory, 12)


@pytest.fixture(scope="module")
def horizon_root(tmp_path_factory):
    """The same cut with the configured horizons (50 and 100)."""
    return _cut(tmp_path_factory, None)


def _run(root, cell, hook=None, seconds=1.0):
    out, checks = harness.run(cell, SEED, seconds, False, root=root, require_card=False,
                              device=torch.device("cpu"), cell_hook=hook)
    return out["correct"], checks


def _stale_state(mpc):
    """The compiled step returns the state it was given (with the diagnostics of a real solve)."""
    step = mpc.jitted_get_control

    def stale(state, *args, **kwargs):
        _, diags = step(state, *args, **kwargs)
        return state, diags

    mpc.__dict__["jitted_get_control"] = stale


def _altered_command(mpc):
    """The compiled step's first command altered where it is produced."""
    step = mpc.jitted_get_control

    def altered(state, *args, **kwargs):
        new, diags = step(state, *args, **kwargs)
        pc = new.projected_control.clone()
        pc[0, 0] += 0.5
        return dataclasses.replace(new, projected_control=pc), diags

    mpc.__dict__["jitted_get_control"] = altered


def _fused(fault):
    def hook(cell):
        mpc = cell.mpc
        step = mpc.batched_get_control_fused

        def broken(states, refs, *args, **kwargs):
            new, diags = step(states, refs, *args, **kwargs)
            return fault(states, new), diags

        mpc.batched_get_control_fused = broken
    return hook


def _half(states, new):
    """Half of the batch left out: its lanes keep the states they came with."""
    B = new.qp_x.shape[0]
    keep = torch.arange(B) >= B // 2
    return type(new)(*(torch.where(keep.reshape((B,) + (1,) * (a.dim() - 1)), b, a)
                       for a, b in zip(dataclasses.astuple(new), dataclasses.astuple(states))))


def _lane_altered(states, new):
    pc = new.projected_control.clone()
    pc[1, 1, 0] += 0.05
    return dataclasses.replace(new, projected_control=pc)


CONTROL = "monza_mapping_h100.control_b1"
SWEEP = "monza_racing_h50.sweep_b256"
CAMERA = "monza_racing_h50.camera_b1"


@pytest.mark.parametrize("cell", [CONTROL, SWEEP, CAMERA])
def test_sound_runs_are_correct(small_root, cell):
    correct, checks = _run(small_root, cell)
    assert correct, checks


@pytest.mark.parametrize("cell,hook", [
    (CONTROL, lambda c: _stale_state(c.mpc)),
    (CONTROL, lambda c: _altered_command(c.mpc)),
    (SWEEP, _fused(lambda states, new: states)),
    (SWEEP, _fused(_half)),
    (SWEEP, _fused(_lane_altered)),
    (CAMERA, lambda c: _stale_state(c.mpc)),
    (CAMERA, lambda c: _altered_command(c.mpc)),
], ids=["control-stale", "control-altered", "sweep-stale", "sweep-half", "sweep-altered",
        "camera-stale", "camera-altered"])
def test_a_broken_step_is_not_correct(small_root, cell, hook):
    correct, checks = _run(small_root, cell, hook)
    assert not correct, checks


def test_an_altered_mask_is_not_correct(small_root):
    def hook(cell):
        pipeline = cell.perceiver._pipeline

        def altered(image):
            drivable, semantics, tracks = pipeline(image)
            drivable = drivable.clone()
            drivable[: drivable.shape[0] // 2, : drivable.shape[1] // 8] ^= 1
            return drivable, semantics, tracks

        cell.perceiver._pipeline = altered

    correct, checks = _run(small_root, CAMERA, hook)
    assert not correct
    assert dict((n, v > lim) for n, v, lim in checks)["mask_gap"]


@pytest.mark.parametrize("cell", [CONTROL, SWEEP, CAMERA])
def test_the_control_is_not_correct(horizon_root, cell):
    out, checks, control = harness.run(cell, SEED, 1.0, False, root=horizon_root, require_card=False,
                                       device=torch.device("cpu"), control=True)
    assert out["correct"], checks
    assert not harness.judged(control), control
