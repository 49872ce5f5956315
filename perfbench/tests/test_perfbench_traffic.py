"""The traffic generators repeat for a seed and differ between seeds."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from perfbench import frames
from perfbench.drivers.sweep import draw_grid
from perfbench.reference import sweep as S

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAP = ROOT / "data" / "maps" / "monza.npz"
TRAFFIC = ROOT / "perfbench" / "traffic"
SEEDS = (2**31 + 11, 2**31 + 12)  # seeds above 32 signed bits, as the check draws them
CAM = {"image_width": 64, "image_height": 32, "vertical_fov_deg": 60,
       "camera_position": [0.0, 0.0, 1.2], "camera_pitch_deg": 9.0}


def _grid(seed):
    traffic = json.loads((TRAFFIC / "sweep_b256.json").read_text())
    return draw_grid(np.random.default_rng(seed), traffic, 11_714)


def test_sweep_grid_repeats_for_a_seed_and_differs_between_seeds():
    a, b, c = _grid(SEEDS[0]), _grid(SEEDS[0]), _grid(SEEDS[1])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    assert a["start_index"].shape == (256,)
    assert np.all(np.abs(a["lateral_offset"]) <= 3.0)
    assert np.all((a["v_max"] >= 0.8 * 24.0) & (a["v_max"] <= 1.1 * 24.0))


def _frames(seed):
    centre = S.load_centre(str(MAP))
    rng = np.random.default_rng(seed)
    rows = frames.poses(centre, rng, 2, 3, 2.0, 1.5, 3.0)
    gen = torch.Generator().manual_seed(int(rng.integers(2**62)))
    return rows, frames.render(centre, CAM, rows, 5.0, gen, torch.device("cpu"))


def test_frames_repeat_for_a_seed_and_differ_between_seeds():
    (ra, fa), (rb, fb), (rc, fc) = _frames(SEEDS[0]), _frames(SEEDS[0]), _frames(SEEDS[1])
    np.testing.assert_array_equal(ra, rb)
    assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
    assert not np.array_equal(ra, rc)
    assert not any(np.array_equal(x, y) for x, y in zip(fa, fc))
    assert fa[0].shape == (32, 64, 3) and fa[0].dtype == np.uint8


def test_poses_stay_in_the_corridor_and_keep_their_spacing():
    centre = S.load_centre(str(MAP))
    rows = frames.poses(centre, np.random.default_rng(SEEDS[0]), 8, 32, 2.0, 1.5, 3.0)
    c = torch.as_tensor(centre)
    d = torch.sqrt(S.sq_dist(c, torch.as_tensor(rows[:, 0]), torch.as_tensor(rows[:, 1])).min(dim=-1).values)
    assert float(d.max()) < 1.6
    steps = np.linalg.norm(np.diff(rows[:32, :2], axis=0), axis=1)
    assert np.all(np.abs(steps - 2.0) < 0.5)


def test_control_car_starts_repeat_for_a_seed():
    centre = torch.as_tensor(S.load_centre(str(MAP)))
    def start(seed):
        rng = np.random.default_rng(seed)
        return S.start(centre, torch.tensor(int(rng.integers(len(centre)))), torch.tensor(rng.normal()))
    a, b, c = start(SEEDS[0]), start(SEEDS[0]), start(SEEDS[1])
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x"], c["x"])


def test_judged_sweep_steps_are_drawn_over_the_whole_window():
    from perfbench.drivers.sweep import Cell

    traffic = json.loads((TRAFFIC / "sweep_b256.json").read_text())

    def kept(seed, steps):
        cell = Cell.__new__(Cell)
        cell.traffic, cell.kept, cell.sample_rng = traffic, {}, np.random.default_rng(seed)
        for cell.steps in range(steps):
            cell.keep(cell.steps, None)
        return sorted(before for before, _ in cell.kept.values())

    a, b, c = kept(SEEDS[0], 3000), kept(SEEDS[0], 3000), kept(SEEDS[1], 3000)
    assert a == b and a != c
    assert len(a) == traffic["check_steps"] == len(set(a))
    assert max(a) > 1500 and max(c) > 1500  # not the window's first steps alone
    assert kept(SEEDS[0], 5) == [0, 1, 2, 3, 4]  # a short window keeps every step
