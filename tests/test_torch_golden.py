"""The port alone against the golden control fixtures
(tests/fixtures/golden_controls.npz, made by tools/gen_golden.py with the
JAX package): every track config's racing MPC at horizon 50 on the five
battery windows, on the CPU."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.dynamics import SpatialBicycleModel
from acmpc_tpu_torch.geometry.tracks import battery
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_controls.npz"
HORIZON = 50
TRACKS = [
    "monza", "spa", "silverstone", "nordschleife",
    "vallelunga", "bathurst", "yas_marina",
]
# the fixture's own tolerance (tests/test_golden.py)
TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.mark.parametrize("track", TRACKS)
def test_port_matches_golden(track, golden):
    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=HORIZON)
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle,
        min_velocity=control.constraints.v_min,
        max_velocity=control.constraints.v_max,
    )
    mpc = SpatialMPC(control, model, device="cpu")
    v_cap = min(30.0, control.unlocalised_max_speed or 30.0)
    for name, ref in battery(HORIZON).items():
        key = f"{track}/{name}"
        state, _ = mpc.get_control(mpc.initial_state(), ref.astype(np.float32), v_cap)
        assert bool(state.solved) == bool(golden[f"{key}/solved"]), key
        if not bool(state.solved):
            continue
        for field in ("projected_control", "cum_time"):
            np.testing.assert_allclose(
                getattr(state, field).numpy(), golden[f"{key}/{field}"],
                err_msg=f"{key}/{field}", **TOL,
            )


def test_batched_step_matches_golden(golden):
    """The batched entry (one kernel launch per chunk for the whole batch)
    on the monza battery gives the same commands as the fixture."""
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=HORIZON)
    model = SpatialBicycleModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max)
    mpc = SpatialMPC(control, model, device="cpu")
    windows = battery(HORIZON)
    refs = np.stack(list(windows.values())).astype(np.float32)
    v_cap = min(30.0, control.unlocalised_max_speed or 30.0)
    state, _ = mpc.batched_get_control_fused(
        mpc.initial_state(len(refs)), refs, v_max=np.full(len(refs), v_cap, np.float32)
    )
    for i, name in enumerate(windows):
        key = f"monza/{name}"
        assert bool(state.solved[i]) == bool(golden[f"{key}/solved"]), key
        np.testing.assert_allclose(
            state.projected_control[i].numpy(), golden[f"{key}/projected_control"],
            err_msg=key, **TOL,
        )
