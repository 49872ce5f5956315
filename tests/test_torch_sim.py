"""The port's SyntheticSimulator against the JAX package's: from the same
map, camera and actions, the same masks, camera frames, state dicts and
poses, bit for bit (both are the same numpy code on float64 state; the
maps hold the same fp32 values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.localise.track_map import TrackMap as JTrackMap
from acmpc_tpu.perception.camera import CameraInfo as JCamera
from acmpc_tpu.runtime.sim import SyntheticSimulator as JSim
from acmpc_tpu_torch.convert import track_map_from_numpy
from acmpc_tpu_torch.geometry.tracks import offset_boundaries
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime.sim import SimulatorInterface, SyntheticSimulator

N_STEPS = 20


def _circuit(n=600, radius=60.0):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = radius + 6.0 * np.sin(3 * theta)
    centre = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    left, right = offset_boundaries(centre, 5.0)
    return {k: v.astype(np.float32) for k, v in zip(("centre", "left", "right"), (centre, left, right))}


def _pair(width, height, **kw):
    arrays = _circuit()
    camera = dict(width=width, height=height, vertical_fov_deg=60.0, position=(0.0, 0.0, 1.2), pitch_deg=9.0)
    jsim = JSim(JTrackMap(**{k: jnp.asarray(v) for k, v in arrays.items()}), JCamera(**camera), **kw)
    sim = SyntheticSimulator(track_map_from_numpy(arrays, device="cpu"), CameraInfo(**camera), **kw)
    return jsim, sim


def _actions():
    k = np.arange(N_STEPS)
    steering = 0.3 * np.sin(k / 3.0)
    brake = np.where(k % 7 == 3, 0.4, 0.0)
    throttle = np.where(k % 7 == 3, 0.0, 0.6)
    return np.stack([steering, brake, throttle], axis=1)


def _assert_obs_equal(want: dict, got: dict):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["drivable_mask"], want["drivable_mask"])
    assert got["image"].dtype == np.uint8 and got["drivable_mask"].dtype == np.uint8
    assert got["state"] == want["state"]
    assert got["is_image_stale"] == want["is_image_stale"]


@pytest.mark.parametrize(
    "size, kw",
    [
        ((160, 96), dict(start_index=0)),
        ((160, 96), dict(start_index=250, dt=0.2, half_width=4.0)),
        ((320, 192), dict(start_index=123)),
    ],
    ids=["160x96", "160x96-dt0.2", "320x192"],
)
def test_sim_matches_jax_over_fixed_actions(size, kw):
    jsim, sim = _pair(*size, **kw)
    _assert_obs_equal(jsim.reset(), sim.reset())
    for action in _actions():
        _assert_obs_equal(jsim.step(action), sim.step(action))
        np.testing.assert_array_equal(sim.pose, jsim.pose)
        assert sim.clock() == jsim.clock()
    assert sim.distance == jsim.distance and sim.laps == jsim.laps


def test_sim_without_mask_rendering_matches_jax():
    jsim, sim = _pair(160, 96, render_mask=False)
    _assert_obs_equal(jsim.reset(), sim.reset())
    assert sim.render_drivable_mask().sum() == 0
    _assert_obs_equal(jsim.step(np.array([0.0, 0.0, 1.0])), sim.step(np.array([0.0, 0.0, 1.0])))


def test_sim_counts_laps_like_jax():
    # a long dt so that 20 steps go round the small circuit
    jsim, sim = _pair(64, 32, start_index=590, dt=1.5, initial_speed=10.0)
    for _ in range(N_STEPS):
        _assert_obs_equal(jsim.step(np.array([0.0, 0.0, 0.0])), sim.step(np.array([0.0, 0.0, 0.0])))
    assert sim.laps == jsim.laps


def test_sim_takes_a_map_on_another_device_as_host_copy():
    arrays = _circuit()
    tm = track_map_from_numpy(arrays, device="cpu")
    cam = CameraInfo(64, 32, 60.0, (0.0, 0.0, 1.2), 9.0)
    sim = SyntheticSimulator(tm, cam)
    assert isinstance(sim, SimulatorInterface)
    assert sim._centre.dtype == np.float64
    np.testing.assert_array_equal(sim._centre, arrays["centre"].astype(np.float64))
    assert torch.equal(tm.centre, torch.from_numpy(arrays["centre"]))
