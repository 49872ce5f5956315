"""Closed-loop lap sweep: the port's LapSweep against the JAX package's on
the same grids, cars and carried states (CPU, horizon 16, an 800-point
asymmetric circuit).

The two packages' fp32 KKT inverses differ in rounding, so over many
steps a car may cross an argmin tie and take another window. The port
is therefore held to the JAX step one step at a time (teacher forcing:
the JAX run's cars and states go into the port's step at every step);
the free-running loop is held to the JAX package's own run-vs-fused
tolerance and to the summary statistics."""

import dataclasses
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.bench import LapSweep as JSweep, SweepGrid as JGrid
from acmpc_tpu.bench.lap_sweep import CarState as JCar
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel, VehicleParams as JVehicle
from acmpc_tpu.mpc import spatial_mpc as jmpc
from acmpc_tpu.qp.speed_profile import SpeedProfileConstraints as JConstraints
from acmpc_tpu_torch.bench import CarState, LapSweep, SweepGrid
from acmpc_tpu_torch.convert import (
    car_state_from_numpy,
    car_state_to_numpy,
    mpc_state_from_numpy,
    mpc_state_to_numpy,
    sweep_grid_from_numpy,
    track_map_from_numpy,
)
from acmpc_tpu_torch.dynamics import SpatialBicycleModel, VehicleParams
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig, MPCState, SpatialMPC
from acmpc_tpu_torch.qp.speed_profile import SpeedProfileConstraints

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_localise import make_asymmetric_map  # noqa: E402

HORIZON = 16
N_MAP = 800
CONSTRAINTS = dict(
    v_min=5.0, v_max=25.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0
)
CONTROL = dict(
    horizon=HORIZON, step_cost=(4.0e-3, 5.0e-2, 0.0), r_term=(1.0e-2, 10.0),
    final_cost=(1.0, 0.0, 0.1),
)
# elementwise fp32 in two libraries (sin, cos, atan2, tan: 1 ulp apart)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
# commands after a solve: both stop at a 1e-3 residual on fp32
# factorisations that differ in rounding (the golden fixture's tolerance)
SOLVE_TOL = dict(rtol=5e-3, atol=5e-3)
# the JAX package's own run-vs-fused tolerance (tests/test_lap_sweep.py)
LOOP_TOL = dict(rtol=5e-3, atol=5e-2)
CAR_FIELDS = ("x", "y", "yaw", "v")
STATE_FIELDS = [f.name for f in dataclasses.fields(MPCState)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    """(JAX sweep, port sweep) on the same map and MPC configuration,
    and the map's numpy arrays."""
    jmpc_ = jmpc.SpatialMPC(
        jmpc.MPCConfig(constraints=JConstraints(**CONSTRAINTS), **CONTROL),
        JModel(JVehicle(), 5.0, 25.0),
    )
    ours = SpatialMPC(
        MPCConfig(constraints=SpeedProfileConstraints(**CONSTRAINTS), **CONTROL),
        SpatialBicycleModel(VehicleParams(), 5.0, 25.0),
        device="cpu",
    )
    jtm = make_asymmetric_map(N_MAP)
    arrays = {f: np.asarray(getattr(jtm, f)) for f in ("centre", "left", "right")}
    ttm = track_map_from_numpy(arrays, device="cpu")
    return JSweep(jmpc_, jtm, half_width=5.0, dt=0.1), LapSweep(ours, ttm, half_width=5.0, dt=0.1), arrays


@pytest.fixture(scope="module")
def speeds_pair(pair):
    """Both sweeps with a per-point speed profile (localised mode)."""
    js, ts, arrays = pair
    theta = np.linspace(0.0, 2.0 * np.pi, N_MAP - 1)
    speeds = (14.0 + 4.0 * np.sin(3.0 * theta)).astype(np.float32)
    return (
        JSweep(js.mpc, js.map, half_width=5.0, dt=0.1, reference_speeds=speeds),
        LapSweep(ts.mpc, ts.map, half_width=5.0, dt=0.1, reference_speeds=speeds),
    )


def _grid(seed, batch=4, v_max=20.0):
    """The perturbed grid's distribution, drawn with numpy so both
    packages see the same grid."""
    rng = np.random.default_rng(seed)
    return {
        "start_index": rng.integers(0, N_MAP, batch).astype(np.int32),
        "lateral_offset": np.clip(1.5 * rng.normal(size=batch), -3.0, 3.0).astype(np.float32),
        "v_max": (v_max * rng.uniform(0.8, 1.1, batch)).astype(np.float32),
    }


def _jgrid(arrays):
    return JGrid(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _jcar(arrays):
    return JCar(**{k: jnp.asarray(arrays[k]) for k in CAR_FIELDS})


def _np_tree(value, fields):
    return {f: np.asarray(getattr(value, f)) for f in fields}


def _random_cars(pair, seed, batch=6):
    """Cars near the centreline with random headings and speeds."""
    _, _, arrays = pair
    rng = np.random.default_rng(seed)
    centre = arrays["centre"]
    pos = centre[rng.integers(0, N_MAP, batch)] + rng.normal(0, 2.0, (batch, 2))
    return {
        "x": pos[:, 0].astype(np.float32),
        "y": pos[:, 1].astype(np.float32),
        "yaw": rng.uniform(-np.pi, np.pi, batch).astype(np.float32),
        "v": rng.uniform(0.0, 25.0, batch).astype(np.float32),
    }


def _random_states(seed, batch=6):
    """Carried states whose commands and clock are random but ordered."""
    rng = np.random.default_rng(seed)
    n = HORIZON - 1
    ours = SpatialMPC(
        MPCConfig(constraints=SpeedProfileConstraints(**CONSTRAINTS), **CONTROL),
        SpatialBicycleModel(VehicleParams(), 5.0, 25.0),
        device="cpu",
    )
    out = mpc_state_to_numpy(ours.initial_state(batch))
    out["projected_control"] = rng.normal(size=(batch, 2, n)).astype(np.float32)
    out["projected_control"][:, 1] *= 0.1
    steps = rng.uniform(0.01, 0.15, (batch, n - 1))
    out["cum_time"] = np.concatenate([np.zeros((batch, 1)), np.cumsum(steps, 1)], 1).astype(np.float32)
    out["solved"] = rng.random(batch) < 0.7
    return out


def test_init_car_matches_jax(pair):
    js, ts, _ = pair
    g = _grid(0, batch=8)
    got = car_state_to_numpy(ts._init_car(sweep_grid_from_numpy(g, device="cpu")))
    want = _np_tree(jax.vmap(js._init_car)(_jgrid(g)), CAR_FIELDS)
    for f in CAR_FIELDS:
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **FLOAT_TOL)


@pytest.mark.parametrize("seed", range(2))
def test_ego_window_matches_jax(pair, seed):
    js, ts, _ = pair
    cars = _random_cars(pair, seed)
    ref, i0 = ts._ego_window(car_state_from_numpy(cars, device="cpu"))
    jref, ji0 = jax.vmap(js._ego_window)(_jcar(cars))
    np.testing.assert_array_equal(i0.numpy(), np.asarray(ji0))
    assert ref.shape == (len(cars["x"]), HORIZON, 3)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **FLOAT_TOL)
    # an unbatched car gives the same window
    one = CarState(*(torch.as_tensor(cars[f][0]) for f in CAR_FIELDS))
    ref1, i01 = ts._ego_window(one)
    assert int(i01) == int(i0[0])
    np.testing.assert_array_equal(ref1.numpy(), ref[0].numpy())


def test_shift_stages_matches_jax(pair):
    js, ts, _ = pair
    rng = np.random.default_rng(2)
    prev = rng.integers(0, N_MAP, 64)
    # forward slides, ties, backward slips and wraps around the map's end
    jumps = np.concatenate([rng.integers(0, 40, 32), -rng.integers(1, 5, 16), rng.integers(350, 450, 16)])
    i0 = (prev + jumps) % N_MAP
    got = ts._shift_stages(torch.as_tensor(i0), torch.as_tensor(prev))
    want = jax.vmap(js._shift_stages)(jnp.asarray(i0, jnp.int32), jnp.asarray(prev, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[32:48].max()) == 0  # backward slips: no shift


@pytest.mark.parametrize("elapsed", [-0.5, 0.0, 0.05, 0.1, 0.37, 10.0])
def test_select_command_matches_jax(pair, elapsed):
    js, ts, _ = pair
    arrays = _random_states(3)
    got = ts._select_command(mpc_state_from_numpy(arrays, device="cpu"), elapsed)
    jstate = jmpc.MPCState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = jax.vmap(lambda s: js._select_command(s, elapsed))(jstate)
    for g, w in zip(got, want):
        # a gather: equal
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_integrate_matches_jax(pair):
    js, ts, _ = pair
    cars = _random_cars(pair, 4)
    arrays = _random_states(4)
    i0 = np.arange(6) * 100
    got_car, got = ts._integrate(
        car_state_from_numpy(cars, device="cpu"),
        mpc_state_from_numpy(arrays, device="cpu"),
        torch.as_tensor(i0),
    )
    jstate = jmpc.MPCState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want_car, want = jax.vmap(js._integrate)(_jcar(cars), jstate, jnp.asarray(i0, jnp.int32))
    for f in CAR_FIELDS:
        np.testing.assert_allclose(
            getattr(got_car, f).numpy(), np.asarray(getattr(want_car, f)), err_msg=f, **FLOAT_TOL
        )
    np.testing.assert_allclose(got["offtrack"].numpy(), np.asarray(want["offtrack"]), **FLOAT_TOL)
    np.testing.assert_array_equal(got["solved"].numpy(), np.asarray(want["solved"]))
    np.testing.assert_array_equal(got["map_index"].numpy(), np.asarray(want["map_index"]))


def test_runtime_v_max_matches_jax(speeds_pair):
    js, ts = speeds_pair
    i0 = np.array([0, 1, 5, 400, N_MAP - 3, N_MAP - 1])
    caps = np.full(len(i0), 30.0, np.float32)
    caps[1] = 9.0  # the grid's cap below the profile's mean
    got = ts._runtime_v_max(torch.as_tensor(caps), torch.as_tensor(i0))
    want = jax.vmap(js._runtime_v_max)(jnp.asarray(caps), jnp.asarray(i0, jnp.int32))
    # a mean over the window in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    assert float(got[1]) == 9.0
    np.testing.assert_array_equal(ts._speed_window.numpy(), np.arange(*js._speed_window))


def _teacher_forced(js, ts, grid, n_steps):
    """Run the JAX fused step ``n_steps`` times; before each, feed its
    cars and states to the port's step and compare what comes out."""
    jg = _jgrid(grid)
    cars = jax.vmap(js._init_car)(jg)
    batch = len(grid["v_max"])
    states = jax.vmap(lambda _: js.mpc.initial_state())(jnp.arange(batch))
    _, prev = jax.vmap(js._ego_window)(cars)
    v_max = torch.as_tensor(grid["v_max"])
    worst = 0.0
    for step in range(n_steps):
        t_cars, t_states, t_metrics, t_i0 = ts.fused_step(
            car_state_from_numpy(_np_tree(cars, CAR_FIELDS), device="cpu"),
            mpc_state_from_numpy(_np_tree(states, STATE_FIELDS), device="cpu"),
            v_max,
            torch.as_tensor(np.array(prev)),
        )
        cars, states, metrics, prev = js._fused_step(cars, states, jg.v_max, prev)
        msg = f"step {step}"
        np.testing.assert_array_equal(t_i0.numpy(), np.asarray(prev), err_msg=msg)
        np.testing.assert_array_equal(t_metrics["map_index"].numpy(), np.asarray(metrics["map_index"]))
        np.testing.assert_array_equal(t_metrics["solved"].numpy(), np.asarray(metrics["solved"]))
        for k in ("v", "offtrack"):
            np.testing.assert_allclose(
                t_metrics[k].numpy(), np.asarray(metrics[k]), err_msg=f"{msg} {k}", **SOLVE_TOL
            )
        got_pc = t_states.projected_control.numpy()
        np.testing.assert_allclose(
            got_pc, np.asarray(states.projected_control), err_msg=msg, **SOLVE_TOL
        )
        worst = max(worst, float(np.abs(got_pc - np.asarray(states.projected_control)).max()))
    return metrics, worst


def test_teacher_forced_fused_steps_match_jax(pair):
    js, ts, _ = pair
    metrics, _ = _teacher_forced(js, ts, _grid(3), 10)
    assert bool(np.asarray(metrics["solved"]).all())


def test_teacher_forced_localised_steps_match_jax(speeds_pair):
    """The speed-profile case: a windowed-mean runtime cap per scenario and
    the localised speed profile, through the batched step."""
    js, ts = speeds_pair
    metrics, _ = _teacher_forced(js, ts, _grid(5, v_max=25.0), 4)
    assert bool(np.asarray(metrics["solved"]).all())


@pytest.fixture(scope="module")
def free_run(pair):
    js, ts, _ = pair
    grid = _grid(7)
    _, jmetrics = js.run_fused(_jgrid(grid), 15)
    cars, metrics = ts.run_fused(sweep_grid_from_numpy(grid, device="cpu"), 15)
    return grid, jmetrics, cars, metrics


def test_free_running_fused_sweep_matches_jax(pair, free_run):
    js, ts, _ = pair
    _, jmetrics, _, metrics = free_run
    assert metrics["v"].shape == (4, 15)
    np.testing.assert_allclose(metrics["v"].numpy(), np.asarray(jmetrics["v"]), **LOOP_TOL)
    ours, ref = ts.summarise(metrics, 15), js.summarise(jmetrics, 15)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            np.testing.assert_allclose(ours[k], v, err_msg=k, **LOOP_TOL)
        else:
            assert ours[k] == v, k
    assert ours["solve_success_rate"] == 1.0


def test_run_matches_run_fused(pair, free_run):
    """The per-scenario loop (get_control at B = 1) against the batched
    sweep, as the JAX package's test_fused_sweep_matches_vmap_sweep."""
    _, ts, _ = pair
    grid, _, cars, metrics = free_run
    run_cars, run_metrics = ts.run(sweep_grid_from_numpy(grid, device="cpu"), 15)
    assert set(run_metrics) == set(metrics)
    assert run_metrics["v"].shape == metrics["v"].shape
    np.testing.assert_allclose(run_metrics["v"].numpy(), metrics["v"].numpy(), **LOOP_TOL)
    np.testing.assert_allclose(run_cars.x.numpy(), cars.x.numpy(), **LOOP_TOL)


def test_raceline_tracking_sweep(pair):
    """The sweep tracks another polyline with per-point widths; the
    off-track metric still measures against the map centreline."""
    _, ts, arrays = pair
    centre, left = arrays["centre"], arrays["left"]
    to_left = left - centre
    to_left /= np.linalg.norm(to_left, axis=1, keepdims=True)
    line = centre + 1.5 * to_left
    widths = np.full(len(line), 2.0 * (5.0 - 1.5), np.float32)
    sweep = LapSweep(
        ts.mpc, ts.map, half_width=5.0, dt=0.1, reference_polyline=line, reference_widths=widths
    )
    grid = SweepGrid(
        start_index=torch.tensor([50, 400]),
        lateral_offset=torch.zeros(2),
        v_max=torch.full((2,), 18.0),
    )
    _, metrics = sweep.run_fused(grid, 30)
    s = sweep.summarise(metrics, 30)
    assert s["solve_success_rate"] > 0.9
    off = metrics["offtrack"].numpy()[:, -10:]
    assert 0.5 < off.mean() < 3.0, f"mean offset {off.mean():.2f}"
    assert off.max() < 5.0


def test_summarise_matches_jax(pair):
    js, ts, _ = pair
    rng = np.random.default_rng(11)
    B, N = 6, 12
    metrics = {
        "v": rng.uniform(0, 25, (B, N)).astype(np.float32),
        "offtrack": rng.uniform(0, 6, (B, N)).astype(np.float32),
        "solved": rng.random((B, N)) < 0.8,
        "control_status": rng.integers(0, 4, (B, N)).astype(np.int32),
    }
    metrics["solved"][2] = False  # a persistent failure
    ours = ts.summarise({k: torch.as_tensor(v) for k, v in metrics.items()}, N)
    assert ours == js.summarise(metrics, N)
    assert ours["fail_persistent_scenarios"] >= 1


def test_sweep_grids():
    regular = SweepGrid.regular(5, N_MAP, v_max=21.0, device="cpu")
    want = JGrid.regular(5, N_MAP, v_max=21.0)
    np.testing.assert_array_equal(regular.start_index.numpy(), np.asarray(want.start_index))
    np.testing.assert_array_equal(regular.v_max.numpy(), np.asarray(want.v_max))
    g = torch.Generator().manual_seed(0)
    grid = SweepGrid.perturbed(g, 256, N_MAP, v_max=20.0)
    assert grid.start_index.dtype == torch.int64
    assert 0 <= int(grid.start_index.min()) and int(grid.start_index.max()) < N_MAP
    assert float(grid.lateral_offset.abs().max()) <= 3.0
    assert 16.0 <= float(grid.v_max.min()) and float(grid.v_max.max()) <= 22.0
    again = SweepGrid.perturbed(torch.Generator().manual_seed(0), 256, N_MAP, v_max=20.0)
    assert torch.equal(again.start_index, grid.start_index)


def test_converters_round_trip():
    cars = {f: np.arange(3, dtype=np.float32) + i for i, f in enumerate(CAR_FIELDS)}
    back = car_state_to_numpy(car_state_from_numpy(cars, device="cpu"))
    for f in CAR_FIELDS:
        np.testing.assert_array_equal(back[f], cars[f])
    grid = sweep_grid_from_numpy(_grid(0), device="cpu")
    assert grid.start_index.dtype == torch.int64 and grid.v_max.dtype == torch.float32


def test_run_laps_on_shipped_map():
    """The full-lap loop on the shipped circuit (the mirror of
    tests/test_tools.py's check of tools/full_lap.py), centreline and
    raceline with its speed profile, a few steps on the CPU."""
    from acmpc_tpu_torch.bench.full_lap import (
        HALF_WIDTH, MAP, closed_loop_mpc, raceline_sweep, run_laps,
    )
    from acmpc_tpu_torch.localise.track_map import load_track_map

    mpc = closed_loop_mpc("cpu")
    tm = load_track_map(MAP, device="cpu")
    grid = SweepGrid.perturbed(torch.Generator().manual_seed(0), 2, tm.n_centre, v_max=24.0)
    out = run_laps(LapSweep(mpc, tm, half_width=HALF_WIDTH), grid, 0.1, max_steps=6)
    assert out["total_solves"] == 12 and out["sequential_solves_per_scenario"] == 6
    assert out["solve_success_rate"] == 1.0 and out["failure_status_histogram"] == {}
    assert out["completed_laps"] == 0 and out["lap_time_s_mean"] is None
    assert abs(out["map_km"] - 21.97) < 0.01

    rsweep, rgrid = raceline_sweep(mpc, tm, grid, 0.1)
    assert rsweep._speeds is not None and float(rgrid.lateral_offset.abs().max()) == 0.0
    r = run_laps(rsweep, rgrid, 0.1, max_steps=3)
    assert r["total_solves"] == 6 and r["solve_success_rate"] >= 0.9
