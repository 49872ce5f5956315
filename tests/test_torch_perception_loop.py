"""The camera-to-command loop (``bench/perception_loop.py``) against the JAX
package's, built from the same pieces as ``bench.py``'s
``_perception_in_loop``: the shipped checkpoint at 320x192 in fp32 with
the training camera, the banded extraction, the centreline taken every
``n_polyfit_points // horizon`` points with tapered widths, and the
closed-loop MPC (horizon 50, a real-time-iteration budget of 50).

Teacher forcing: the JAX loop runs free for a few frames around the
circuit; at each frame its carried MPC state and the sim's camera frame
go into the port's step. Tolerances: the reference path to the polyline
tolerance of tests/test_torch_perception.py (rtol 1e-4, atol 1e-3 m:
the fit's ill-conditioned 3x3 normal equations round differently in
the two libraries); the commands to 5e-3, the golden fixture's (both
engines stop on fp32 factorisations that differ in rounding). The JAX
side runs under ``jax.default_matmul_precision("highest")``, since XLA's
CPU convolutions otherwise round fp32 through bf16.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel, VehicleParams as JVehicle
from acmpc_tpu.mpc.spatial_mpc import MPCConfig as JConfig, SpatialMPC as JMPC
from acmpc_tpu.perception.perceiver import Perceiver as JPerceiver
from acmpc_tpu.qp.speed_profile import SpeedProfileConstraints as JConstraints
from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.bench.full_lap import closed_loop_mpc
from acmpc_tpu_torch.convert import mpc_state_from_numpy, mpc_state_to_numpy
from acmpc_tpu_torch.perception.perceiver import Perceiver

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES = 4
POLY_TOL = dict(rtol=1e-4, atol=1e-3)
COMMAND_TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_mpc() -> JMPC:
    """``bench.py``'s ``_closed_loop_mpc``."""
    constraints = JConstraints(
        v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0
    )
    config = JConfig(
        horizon=50, step_cost=(4.0e-3, 5.0e-2, 0.0), r_term=(1.0e-2, 10.0),
        final_cost=(1.0, 0.0, 0.1), constraints=constraints, rti_iterations=50,
    )
    return JMPC(config, JModel(vehicle=JVehicle(), min_velocity=5.0, max_velocity=30.0))


def _jax_step(perc: JPerceiver, mpc: JMPC, n_poly: int):
    """``bench.py``'s ``fused`` (l.575-588), also returning the reference."""
    horizon = mpc.horizon
    ds = max(1, n_poly // horizon)

    def fused(variables, state, image):
        _, _, tracks = perc._run_pipeline(variables, image)
        pts = tracks["centre"][::ds][:horizon]
        if pts.shape[0] < horizon:
            pts = jnp.concatenate([pts, jnp.repeat(pts[-1:], horizon - pts.shape[0], axis=0)])
        widths = jnp.linspace(10.0, 6.0, horizon, dtype=pts.dtype)
        ref = jnp.stack([pts[:, 0], pts[:, 1], widths], axis=1)
        new_state, _ = mpc.get_control(state, ref)
        return new_state, ref

    return jax.jit(fused)


def _jax_state_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def frames():
    """The JAX loop for ``N_FRAMES`` frames, actuated by its own commands:
    per frame (state in, camera frame, reference, state out); and the
    port's loop pieces on the same configuration."""
    cfg = loop.perception_config(320, 192, "fp32")
    jcfg = dataclasses.replace(
        j_load_config(ROOT / "configs" / "monza.yaml").perception,
        **{k: getattr(cfg, k) for k in (
            "image_width", "image_height", "n_rows_to_remove_bonnet", "n_polyfit_points",
            "camera_position", "camera_pitch_deg", "precision",
        )},
    )
    jperc, jmpc = JPerceiver(jcfg), _jax_mpc()
    jstep = _jax_step(jperc, jmpc, jcfg.n_polyfit_points)
    centre, left, right, _ = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    obs, state, out = sim.reset(), jmpc.initial_state(), []
    with jax.default_matmul_precision("highest"):
        for _ in range(N_FRAMES):
            new, ref = jstep(jperc.segmenter.variables, state, jnp.asarray(obs["image"]))
            out.append((_jax_state_numpy(state), obs["image"], np.asarray(ref), _jax_state_numpy(new)))
            state = new
            obs = loop._actuate(sim, state, jmpc.model.vehicle.max_steering_angle)
    perc = Perceiver(cfg, device="cpu")
    return out, loop.make_step(perc, closed_loop_mpc("cpu")), perc, sim


def test_config_is_bench_reduced_size():
    cfg = loop.perception_config(320, 192)
    assert (cfg.image_width, cfg.image_height) == (320, 192)
    assert cfg.n_rows_to_remove_bonnet == 160 and cfg.n_polyfit_points == 200
    assert cfg.camera_position == (0.0, 0.0, 1.2) and cfg.camera_pitch_deg == 9.0
    full = loop.perception_config()
    assert (full.image_width, full.image_height, full.precision) == (1280, 736, "bf16")
    assert full.n_polyfit_points == 500 and full.n_rows_to_remove_bonnet == 600


def test_reference_from_tracks_pads_and_tapers():
    centre = torch.stack([torch.zeros(30), torch.arange(30.0)], dim=1)
    ref = loop.reference_from_tracks(centre, 50, 30)  # ds = 1: 30 points, 20 pads
    assert ref.shape == (50, 3)
    assert torch.equal(ref[:30, :2], centre) and torch.equal(ref[30:, :2], centre[-1:].expand(20, 2))
    np.testing.assert_allclose(ref[:, 2].numpy(), np.linspace(10.0, 6.0, 50), rtol=0, atol=1e-6)
    ref = loop.reference_from_tracks(torch.arange(1000.0).reshape(500, 2), 50, 500)
    assert torch.equal(ref[:, :2], torch.arange(1000.0).reshape(500, 2)[::10])


@pytest.mark.parametrize("k", range(N_FRAMES))
def test_teacher_forced_frame_matches_jax(frames, k):
    out, step, _, _ = frames
    state_in, image, want_ref, want = out[k]
    new, _, ref = step(mpc_state_from_numpy(state_in, device="cpu"), torch.from_numpy(image))
    np.testing.assert_allclose(ref.numpy(), want_ref, **POLY_TOL)
    got = mpc_state_to_numpy(new)
    assert bool(got["solved"]) and bool(want["solved"])
    for field in ("projected_control", "cum_time"):
        np.testing.assert_allclose(got[field], want[field], err_msg=field, **COMMAND_TOL)


def test_loop_runs_on_the_cpu(frames):
    _, _, perc, sim = frames
    centre, _, _, lap_m = loop.circuit()
    run = loop.perception_in_loop(perc, closed_loop_mpc("cpu"), sim, centre, lap_m, frames=3)
    assert run["frames"] == 3 and run["solve_success"] == 1.0
    assert run["max_offtrack_m"] < loop.HALF_WIDTH and not run["lap_completed"]
    assert run["resolution"] == "320x192" and len(run["ms_all"]) == 3
    assert np.isfinite([run["p50_ms"], run["p99_ms"], run["distance_m"]]).all()
