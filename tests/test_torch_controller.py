"""The port's controller against the JAX package's (CPU): the control
thread's solve on perceived centrelines, the elapsed-time command
selection, and the map speed profile of the racing bootstrap.

Centrelines: the JAX extractor's polylines of the sim's ground-truth
masks at five poses of tests/test_localise.py's asymmetric loop, fed in
order to both controllers' ``_solve`` (the warm start carries), at
horizon 20 for the racing and the mapping MPC. Published commands,
cumulative times and predictions agree to 5e-3, the golden fixture's
tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.perception.camera import CameraInfo as JCameraInfo
from acmpc_tpu.perception.tracks import TrackExtractionConfig as JExtractionConfig
from acmpc_tpu.perception.tracks import TrackLimitExtractor as JExtractor
from acmpc_tpu.runtime.controller import Controller as JController
from acmpc_tpu.runtime.controller import _ControlThread as JControlThread
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime.controller import Controller, _ControlThread
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from torch_agent_cases import COMMAND_TOL, SPEED_TOL, FakeClock, configs, on_fake_clock, save_asymmetric_map

POSES = (50, 300, 640, 900, 1210)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = tmp_path_factory.mktemp("controller") / "track.npz"
    centre = save_asymmetric_map(path)
    cfg, jcfg = configs(str(path), mapping=True)
    sim = SyntheticSimulator(
        load_track_map(path, device="cpu"), CameraInfo.from_config(cfg.perception), half_width=5.0
    )
    extract = JExtractor(
        JExtractionConfig.from_config(jcfg.perception), JCameraInfo.from_config(jcfg.perception)
    ).jitted()
    centrelines = []
    for i in POSES:
        p0, p1 = centre[i], centre[(i + 1) % len(centre)]
        sim.x, sim.y = float(p0[0]), float(p0[1])
        # a heading error so the plans steer
        sim.yaw = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0])) + 0.05 * np.sin(i)
        centrelines.append(np.asarray(extract(jnp.asarray(sim.render_drivable_mask()))["centre"]))
    return cfg, jcfg, centre, centrelines


def _published(controller):
    cmds, version, _ = controller._command_box.read()
    return cmds, version


@pytest.mark.parametrize("mode", ["racing", "mapping"])
def test_solve_equals_jax(case, mode):
    cfg, jcfg, _, centrelines = case
    clock = FakeClock(3.0)
    with on_fake_clock(clock):
        ours = Controller(cfg, clock=clock, device="cpu")
        ref = JController(jcfg, clock=clock)
    for c in (ours, ref):
        c.is_mapping = mode == "mapping"
        assert c.mpc.horizon == 20
    thread, jthread = _ControlThread(ours), JControlThread(ref)
    for k, centreline in enumerate(centrelines):
        for c in (ours, ref):
            c.reference_speed = 18.0 + k
            c.is_localised = k >= 3
        thread._solve(centreline, 1.0 + k)
        jthread._solve(centreline, 1.0 + k)
        got, version = _published(ours)
        want, jversion = _published(ref)
        assert version == jversion == k + 1, "a solve was not published"
        assert got.timestamp == want.timestamp == 1.0 + k
        for field in ("controls", "cum_time", "prediction"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.shape == w.shape and g.dtype == np.float32, field
            np.testing.assert_allclose(g, w, err_msg=f"{mode} {k} {field}", **COMMAND_TOL)
    assert ours.n_solves == len(centrelines) and ours.solve_s > 0
    assert ours.predicted_locations.shape == (19, 2)


def test_desired_state_equals_jax(case):
    cfg, jcfg, _, centrelines = case
    clock = FakeClock(10.0)
    with on_fake_clock(clock):
        ours = Controller(cfg, clock=clock, device="cpu")
        ref = JController(jcfg, clock=clock)
    assert ours.desired_state == ref.desired_state == (0.0, 0.0)
    _ControlThread(ours)._solve(centrelines[1], 10.0)
    JControlThread(ref)._solve(centrelines[1], 10.0)
    cum = _published(ref)[0].cum_time
    for elapsed in (0.0, 0.5 * cum[3], cum[7] + 1e-3, cum[-1] + 5.0):
        clock.t = 10.0 + float(elapsed)
        got, want = ours.desired_state, ref.desired_state
        np.testing.assert_allclose(got, want, err_msg=f"elapsed {elapsed}", **COMMAND_TOL)
        assert all(isinstance(v, float) for v in got)
    assert ours.delta_max == pytest.approx(ref.delta_max)
    assert ours.a_max == ref.a_max


def test_track_speed_profile_equals_jax(case):
    cfg, jcfg, centre, _ = case
    ours = Controller(cfg, device="cpu")
    with on_fake_clock(FakeClock()):
        ref = JController(jcfg)
    track = np.stack([centre[:, 0], centre[:, 1], np.full(len(centre), 9.5)]).T
    got = ours.compute_track_speed_profile(track)
    want = ref.compute_track_speed_profile(track)
    assert got.velocities.shape == (len(centre) - 1,)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities), **SPEED_TOL)


def test_controller_thread_publishes_and_stops(case):
    cfg, _, _, centrelines = case
    ours = Controller(dataclasses.replace(cfg, create_map=False), device="cpu")
    assert not ours.is_mapping and ours.mpc is ours.racing_mpc
    ours.start()
    try:
        ours.submit_centreline(centrelines[0])
        assert ours.wait_for_first_command(timeout=60.0)
        version = ours.command_version
        ours.submit_centreline(centrelines[1])
        assert ours.wait_for_command_newer_than(version, timeout=60.0) == version + 1
    finally:
        ours.shutdown()
    assert ours._thread is None


def test_default_device_is_the_card(case):
    cfg = case[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Controller(cfg)
