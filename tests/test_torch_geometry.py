"""Geometry, dynamics and the exact speed profile: the port against the
JAX package on the same numpy inputs (CPU)."""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.dynamics import spatial_bicycle as jsb
from acmpc_tpu.geometry import path as jpath
from acmpc_tpu.qp import speed_profile as jsp
from acmpc_tpu_torch.dynamics import spatial_bicycle as tsb
from acmpc_tpu_torch.geometry import path as tpath
from acmpc_tpu_torch.geometry.tracks import battery
from acmpc_tpu_torch.qp import speed_profile as tsp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
from gen_golden import battery as jax_battery  # noqa: E402

FIELDS = ("xs", "ys", "psis", "kappas", "distances", "widths", "velocities")
# fp32 geometry through atan2/sqrt/remainder in two libraries: results
# agree to a few ulp; curvatures divide small angle differences by ds
TOL = dict(rtol=1e-5, atol=1e-5)
CONSTRAINTS = dict(v_min=8.0, v_max=84.0, a_min=-1.3, a_max=1.0, ay_max=5.5, ki_min=0.005)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _windows(horizon=50):
    return np.stack(list(battery(horizon).values())).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_battery_equals_golden_generator():
    ours, ref = battery(50), jax_battery(50)
    assert list(ours) == list(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name], ref[name])


@pytest.mark.parametrize("horizon", [12, 50])
def test_construct_waypoints_batched(horizon):
    coords = _windows(horizon)
    ours = tpath.construct_waypoints(_t(coords))
    ref = jax.vmap(jpath.construct_waypoints)(jnp.asarray(coords))
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **TOL
        )
    # batched equals per-window
    single = tpath.construct_waypoints(_t(coords[2]))
    np.testing.assert_allclose(single.kappas.numpy(), ours.kappas[2].numpy(), **TOL)


def test_t2s_s2t_and_wrap():
    rng = np.random.default_rng(0)
    wp = rng.normal(size=(6, 3)).astype(np.float32) * [10, 10, 4]
    st = rng.normal(size=(6, 3)).astype(np.float32) * [10, 10, 4]
    np.testing.assert_allclose(
        tsb.t2s(_t(wp), _t(st)).numpy(),
        np.asarray(jax.vmap(jsb.t2s)(jnp.asarray(wp), jnp.asarray(st))),
        **TOL,
    )
    angles = np.linspace(-20, 20, 101).astype(np.float32)
    np.testing.assert_allclose(
        tpath.wrap_to_pi(_t(angles)).numpy(),
        np.asarray(jpath.wrap_to_pi(jnp.asarray(angles))),
        **TOL,
    )
    coords = _windows()
    ours = tpath.construct_waypoints(_t(coords))
    ref = jax.vmap(jpath.construct_waypoints)(jnp.asarray(coords))
    spatial = rng.normal(size=(5, 49, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsb.s2t(ours, _t(spatial)).numpy(),
        np.asarray(jax.vmap(jsb.s2t)(ref, jnp.asarray(spatial))),
        **TOL,
    )


@pytest.mark.parametrize("time_mode", ["reference", "exact"])
def test_linearise(time_mode):
    coords = _windows()
    rng = np.random.default_rng(1)
    vel = rng.uniform(8.0, 30.0, size=(5, 49)).astype(np.float32)
    ours = dataclasses.replace(
        tpath.construct_waypoints(_t(coords)), velocities=_t(vel)
    )
    ref = jax.vmap(jpath.construct_waypoints)(jnp.asarray(coords)).replace(
        velocities=jnp.asarray(vel)
    )
    got = tsb.linearise(ours, time_mode)
    want = jax.vmap(lambda p: jsb.linearise(p, time_mode))(ref)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("end_velocity", [None, 14.0])
def test_velocity_upper_bounds(end_velocity):
    kappas = np.random.default_rng(2).normal(scale=0.02, size=(49,)).astype(np.float32)
    c_t = tsp.SpeedProfileConstraints(**CONSTRAINTS)
    c_j = jsp.SpeedProfileConstraints(**CONSTRAINTS)
    np.testing.assert_allclose(
        tsp.velocity_upper_bounds(_t(kappas), c_t, 28.0, end_velocity).numpy(),
        np.asarray(jsp.velocity_upper_bounds(jnp.asarray(kappas), c_j, 28.0, end_velocity)),
        **TOL,
    )


@pytest.mark.parametrize("localised", [False, True])
@pytest.mark.parametrize("use_end_velocity", [False, True])
def test_speed_profile_batched(localised, use_end_velocity):
    # velocities are sums of up to 48 slacks, summed in another order
    # (Hillis-Steele doubling vs XLA's associative scan)
    coords = _windows()
    ours = tpath.construct_waypoints(_t(coords))
    ref = jax.vmap(jpath.construct_waypoints)(jnp.asarray(coords))
    v_max = np.asarray([28.0, 84.0, 20.0, 30.0, 40.0], np.float32)
    cons = dict(CONSTRAINTS, end_velocity=14.0)
    got = tsp.solve_speed_profile(
        ours.distances, ours.kappas, tsp.SpeedProfileConstraints(**cons),
        v_max_runtime=_t(v_max), localised=localised,
        use_end_velocity=use_end_velocity,
    )
    want = jax.vmap(
        lambda d, k, v: jsp.solve_speed_profile(
            d, k, jsp.SpeedProfileConstraints(**cons), v_max_runtime=v,
            localised=localised, use_end_velocity=use_end_velocity,
        )
    )(ref.distances, ref.kappas, jnp.asarray(v_max))
    np.testing.assert_allclose(
        got.velocities.numpy(), np.asarray(want.velocities), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))


def test_min_plus_scan_matches_sequential_recurrence():
    # exact recurrence x_i = min(c_i, x_{i-1} + s_{i-1}) in float64
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 100):
        caps = rng.uniform(0, 10, size=(3, n))
        slacks = rng.uniform(0, 2, size=(3, max(n - 1, 0)))
        want = caps.copy()
        for i in range(1, n):
            want[:, i] = np.minimum(caps[:, i], want[:, i - 1] + slacks[:, i - 1])
        got = tsp._min_plus_scan(_t(caps), _t(slacks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_infeasible_speed_profile_status():
    # a_max <= 0 cannot lift v above the start: status 0 on both sides
    cons = dict(CONSTRAINTS, a_max=-1.0)
    coords = _windows()[:1]
    ours = tpath.construct_waypoints(_t(coords))
    got = tsp.solve_speed_profile(
        ours.distances, ours.kappas, tsp.SpeedProfileConstraints(**cons)
    )
    ref = jpath.construct_waypoints(jnp.asarray(coords[0]))
    want = jsp.solve_speed_profile(
        ref.distances, ref.kappas, jsp.SpeedProfileConstraints(**cons)
    )
    assert int(got.status[0]) == int(want.status) == 0
