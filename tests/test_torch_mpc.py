"""SpatialMPC: the port against the JAX package on the same inputs and the
same carried state (CPU), plus the two stateful semantics on their own:
shift_warm_start and keep-last-command."""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acmpc_tpu.mpc.spatial_mpc as jmpc
from acmpc_tpu.config import load_config as jax_load_config
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel
from acmpc_tpu.geometry.path import construct_waypoints as jax_waypoints
from acmpc_tpu.qp.admm import QPSolution as JSolution
from acmpc_tpu.qp.speed_profile import solve_speed_profile as jax_speed_profile
from acmpc_tpu_torch.config import load_config, load_raw
from acmpc_tpu_torch.convert import mpc_state_from_numpy, mpc_state_to_numpy
from acmpc_tpu_torch.geometry.path import construct_waypoints
from acmpc_tpu_torch.geometry.tracks import battery
from acmpc_tpu_torch.mpc import spatial_mpc as tmpc
from acmpc_tpu_torch.qp.admm import QPSolution
from acmpc_tpu_torch.qp.speed_profile import solve_speed_profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import __graft_entry__ as ge  # noqa: E402

STATE_FIELDS = [f.name for f in dataclasses.fields(tmpc.MPCState)]
# commands and clock, as tests/test_golden.py: both solves stop at the
# same 1e-3 residual tolerance on fp32 factorisations that differ in
# rounding
TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_state_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}


def _jax_state(arrays):
    return jmpc.MPCState(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _assert_states_close(ours, ref, fields=("projected_control", "cum_time", "prediction", "velocities")):
    ours = mpc_state_to_numpy(ours)
    ref = _jax_state_numpy(ref)
    np.testing.assert_array_equal(ours["solved"], ref["solved"])
    np.testing.assert_array_equal(ours["infeasibility_counter"], ref["infeasibility_counter"])
    for f in fields:
        np.testing.assert_allclose(ours[f], ref[f], err_msg=f, **TOL)


def _monza(horizon=50):
    """(port MPC, JAX MPC) for the monza racing config at ``horizon``."""
    path = ROOT / "configs" / "monza.yaml"
    raw = load_raw(path)["racing"]["control"]
    ours = tmpc.build_mpc(dict(raw, horizon=horizon), load_config(path).vehicle, device="cpu")
    cfg = jax_load_config(path)
    control = dataclasses.replace(cfg.racing_control, horizon=horizon)
    ref = jmpc.SpatialMPC(
        control,
        JModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max),
    )
    return ours, ref


def test_get_control_three_warm_steps_match_jax():
    """Single-scenario steps from the same carried state; between steps the
    warm start shifts by one stage on both sides."""
    ours, ref = _monza()
    windows = battery(50)
    jstate = ref.initial_state()
    for name in ("curve", "chicane", "hairpin_r60"):
        window = windows[name].astype(np.float32)
        state = mpc_state_from_numpy(_jax_state_numpy(jstate), device="cpu")
        new, diags = ours.get_control(state, window, 28.0)
        jnew, jdiags = ref.jitted_get_control(jstate, jnp.asarray(window), jnp.float32(28.0))
        assert bool(new.solved), name
        _assert_states_close(new, jnew)
        assert int(diags.speed_status) == int(jdiags.speed_status) == 1
        jstate = jmpc.shift_warm_start(jnew, 1, 50)
        shifted = tmpc.shift_warm_start(new, 1, 50)
        np.testing.assert_allclose(shifted.qp_x.numpy(), np.asarray(jstate.qp_x), **TOL)


def test_batched_fused_matches_jax():
    horizon, batch = 20, 4
    ours, ref = _monza(horizon)
    refs = np.asarray(ge._reference_window(horizon, batch))
    jstates = jax.vmap(lambda: ref.initial_state(), axis_size=batch)()
    jnew, jdiags = ref.batched_get_control_fused(jstates, jnp.asarray(refs))
    new, diags = ours.batched_get_control_fused(ours.initial_state(batch), refs)
    assert bool(new.solved.all())
    _assert_states_close(new, jnew)
    np.testing.assert_array_equal(
        diags.control_status.numpy(), np.asarray(jdiags.control_status)
    )
    # a second, warm-started step from the JAX carry
    state = mpc_state_from_numpy(_jax_state_numpy(jnew), device="cpu")
    new2, _ = ours.batched_get_control_fused(state, refs)
    jnew2, _ = ref.batched_get_control_fused(jnew, jnp.asarray(refs))
    _assert_states_close(new2, jnew2)


def _random_state(rng, horizon, batch=()):
    ours, _ = _monza(horizon)
    zero = mpc_state_to_numpy(ours.initial_state())
    out = {}
    for f, v in zero.items():
        shape = tuple(batch) + v.shape
        if v.dtype == np.bool_:
            out[f] = rng.random(shape) < 0.5
        elif v.dtype == np.int32:
            out[f] = rng.integers(0, 5, shape).astype(np.int32)
        else:
            out[f] = rng.normal(size=shape).astype(np.float32)
    return out


@pytest.mark.parametrize("k", [0, 1, 5])
def test_shift_warm_start_matches_jax(k):
    # pure data movement: bit-exact
    arrays = _random_state(np.random.default_rng(k), 12)
    got = mpc_state_to_numpy(tmpc.shift_warm_start(mpc_state_from_numpy(arrays, device="cpu"), k, 12))
    want = _jax_state_numpy(jmpc.shift_warm_start(_jax_state(arrays), k, 12))
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_shift_warm_start_per_scenario_k():
    arrays = _random_state(np.random.default_rng(7), 12, batch=(4,))
    ks = np.array([0, 1, 3, 11])
    got = mpc_state_to_numpy(
        tmpc.shift_warm_start(mpc_state_from_numpy(arrays, device="cpu"), torch.as_tensor(ks), 12)
    )
    want = _jax_state_numpy(
        jax.vmap(lambda s, k: jmpc.shift_warm_start(s, k, 12))(_jax_state(arrays), jnp.asarray(ks))
    )
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("speed_ok", [True, False])
@pytest.mark.parametrize("control_status", [0, 1, 2, 3])
def test_extract_keep_last_command_matches_jax(speed_ok, control_status):
    """_extract alone, on the same path, speed profile, QP solution and
    previous carry: a failed solve keeps serving the previous commands,
    zeroes the warm start and counts the failure."""
    horizon = 12
    ours, ref = _monza(horizon)
    rng = np.random.default_rng(control_status + 10 * speed_ok)
    prev = _random_state(rng, horizon)
    window = battery(horizon)["curve"].astype(np.float32)
    n_var, n_con = prev["qp_x"].shape[0], prev["qp_y"].shape[0]
    sol = dict(
        x=rng.normal(size=n_var).astype(np.float32),
        y=rng.normal(size=n_con).astype(np.float32),
        z=rng.normal(size=n_con).astype(np.float32),
        status=np.int32(control_status),
        iterations=np.int32(50),
        r_prim=np.float32(1e-4),
        r_dual=np.float32(2e-4),
    )
    constraints, jconstraints = ours.config.constraints, ref.config.constraints
    if not speed_ok:
        constraints = dataclasses.replace(constraints, a_max=-1.0)
        jconstraints = dataclasses.replace(jconstraints, a_max=-1.0)

    path = construct_waypoints(torch.as_tensor(window))
    speed = solve_speed_profile(path.distances, path.kappas, constraints)
    path = dataclasses.replace(path, velocities=speed.velocities)
    got, _ = ours._extract(
        mpc_state_from_numpy(prev, device="cpu"), path, speed,
        QPSolution(**{k: torch.as_tensor(v) for k, v in sol.items()}),
    )

    jpath = jax_waypoints(jnp.asarray(window))
    jspeed = jax_speed_profile(jpath.distances, jpath.kappas, jconstraints)
    jpath = jpath.replace(velocities=jspeed.velocities)
    want, _ = ref._extract(
        _jax_state(prev), jpath, jspeed, JSolution(**{k: jnp.asarray(v) for k, v in sol.items()})
    )

    got_np, want_np = mpc_state_to_numpy(got), _jax_state_numpy(want)
    for f in STATE_FIELDS:
        # fp32 elementwise (atan, cumsum) in two libraries
        np.testing.assert_allclose(got_np[f], want_np[f], rtol=1e-5, atol=1e-5, err_msg=f)
    accepted = speed_ok and control_status in (1, 3)
    assert bool(got.solved) == accepted
    if not accepted:
        np.testing.assert_array_equal(got_np["projected_control"], prev["projected_control"])
        np.testing.assert_array_equal(got_np["cum_time"], prev["cum_time"])
        assert not got_np["qp_x"].any() and not got_np["qp_y"].any()
        assert int(got.infeasibility_counter) == prev["infeasibility_counter"] + 1
    else:
        assert int(got.infeasibility_counter) == 0


def test_infeasible_window_keeps_previous_commands():
    """End to end: a good solve, then a window the step cannot serve (a
    speed profile with a_max < 0 cannot lift the car to v_min) from that
    carry. Both packages keep the previous commands and count one
    failure."""
    horizon = 30
    ours, ref = _monza(horizon)
    windows = battery(horizon)
    jgood, _ = ref.jitted_get_control(ref.initial_state(), jnp.asarray(windows["straight"], jnp.float32))
    bad = dataclasses.replace(ours.config.constraints, a_max=-1.0)
    ours_bad = tmpc.SpatialMPC(
        dataclasses.replace(ours.config, constraints=bad), ours.model, device="cpu"
    )
    ref_bad = jmpc.SpatialMPC(
        dataclasses.replace(
            ref.config, constraints=dataclasses.replace(ref.config.constraints, a_max=-1.0)
        ),
        ref.model,
    )
    window = windows["hairpin_r30"].astype(np.float32)
    state = mpc_state_from_numpy(_jax_state_numpy(jgood), device="cpu")
    new, diags = ours_bad.get_control(state, window)
    jnew, jdiags = ref_bad.jitted_get_control(jgood, jnp.asarray(window))
    assert bool(jgood.solved)
    assert not bool(new.solved) and not bool(jnew.solved)
    assert int(diags.speed_status) == int(jdiags.speed_status) == 0
    np.testing.assert_array_equal(
        new.projected_control.numpy(), np.asarray(jgood.projected_control)
    )
    np.testing.assert_array_equal(new.cum_time.numpy(), np.asarray(jgood.cum_time))
    assert int(new.infeasibility_counter) == int(jnew.infeasibility_counter) == 1


def test_map_speed_profile_matches_jax():
    ours, ref = _monza()
    theta = np.linspace(0.0, 2.0 * np.pi, 2001)
    r = 3000.0 + 400.0 * np.sin(3 * theta)
    coords = np.stack([r * np.cos(theta), r * np.sin(theta), np.full_like(theta, 9.0)], 1)
    coords = coords.astype(np.float32)
    got = ours.compute_map_speed_profile(ours.construct_waypoints(coords), 7.0, -0.15)
    want = ref.compute_map_speed_profile(ref.construct_waypoints(coords), 7.0, -0.15)
    # up to 2000 slacks summed in other orders
    np.testing.assert_allclose(
        got.velocities.numpy(), np.asarray(want.velocities), rtol=1e-4, atol=1e-3
    )


def test_entry_points_default_to_cuda():
    ours, _ = _monza()
    if torch.cuda.is_available():
        assert tmpc.SpatialMPC(ours.config, ours.model).device.type == "cuda"
    else:
        # no silent CPU fallback
        with pytest.raises(RuntimeError):
            tmpc.SpatialMPC(ours.config, ours.model)
        with pytest.raises(RuntimeError):
            mpc_state_from_numpy(mpc_state_to_numpy(ours.initial_state()))
