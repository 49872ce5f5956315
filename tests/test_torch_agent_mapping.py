"""The port's agent in a mapping session against the JAX package's (CPU).

Teacher-forced (see tests/test_torch_agent.py): 20 mapping frames on
tests/test_mapping_e2e.py's small loop, both agents on one fake clock,
the sim driven by the JAX agent's action; the map makers accumulate the
same frames, to the polyline tolerance of tests/test_torch_perception.py
(the two extractors' fits round differently). Then the finalisation on
a map maker filled with tests/test_mapping.py's simulated lap saves the
same map as JAX's, and the racing bootstrap on it switches the
controller to the racing MPC with the same map speeds.

The free-running counterpart of tests/test_mapping_e2e.py (a whole
mapping lap, then racing on the self-built map) is ``slow``, as the JAX
one is; its lap is paced on solve freshness every frame.
"""

import pathlib

import numpy as np
import pytest
import torch

from acmpc_tpu.runtime import Agent as JAgent
from acmpc_tpu_torch.bench.agent_loop import small_loop_map
from acmpc_tpu_torch.localise.track_map import TrackMap, load_track_map, save_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime import Agent
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from test_mapping_e2e import small_loop_map as j_small_loop_map
from test_torch_mapping import _replay_frames
from torch_agent_cases import (
    COMMAND_TOL,
    SPEED_TOL,
    ClockOnlySim,
    FakeClock,
    configs,
    on_fake_clock,
    stopped_control_thread,
    teacher_forced_frame,
)

FRAMES = 20
POLY_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The small loop saved as .npz, and the paths the two agents' maps
    are written to."""
    tmp = tmp_path_factory.mktemp("mapping")
    tm = small_loop_map()
    save_track_map(tmp / "loop.npz", tm.centre, tm.left, tm.right)
    return tmp, tm


def _pair(tmp: pathlib.Path, clock: FakeClock):
    cfg, _ = configs(str(tmp / "ours.npy"), mapping=True)
    _, jcfg = configs(str(tmp / "jax.npy"), mapping=True)
    ours = Agent(cfg, ClockOnlySim(clock), use_oracle_perception=True, device="cpu")
    ref = JAgent(jcfg, ClockOnlySim(clock), use_oracle_perception=True)
    return ours, ref


def test_small_loop_equals_the_jax_tests():
    ours, ref = small_loop_map(), j_small_loop_map()
    for name in ("centre", "left", "right"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))


def test_teacher_forced_mapping_frames_equal_jax(loop):
    tmp, tm = loop
    clock = FakeClock()
    with on_fake_clock(clock):
        ours, ref = _pair(tmp, clock)
        thread, jthread = stopped_control_thread(ours), stopped_control_thread(ref)
        try:
            assert ours._is_mapping and ref._is_mapping
            assert ours.controller.is_mapping and ours.controller.mpc is ours.controller.mapping_mpc
            sim = SyntheticSimulator(
                load_track_map(tmp / "loop.npz", device="cpu"),
                CameraInfo.from_config(ours.cfg.perception), dt=0.05, start_index=10, half_width=5.0,
            )
            raw = sim.reset()
            for k in range(FRAMES):
                clock.t = sim.t
                want = np.asarray(teacher_forced_frame(ref, jthread, raw, jax_side=True))
                got = teacher_forced_frame(ours, thread, raw, jax_side=False)
                np.testing.assert_allclose(got, want, err_msg=f"frame {k}", **COMMAND_TOL)
                assert ours.controller.command_version == ref.controller.command_version == k + 1
                assert ours._is_mapping and not ours._is_racing_setup
                raw = sim.step(want)
            assert sim.distance > 10.0
            for name in ("xy_points_driven", "outside_track", "inside_track", "centre_track"):
                got, want = getattr(ours.mapper, name), getattr(ref.mapper, name)
                assert len(got) == len(want) > FRAMES // 3, name
                np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name, **POLY_TOL)
        finally:
            ours.teardown()
            ref.teardown()


def test_finalise_mapping_then_racing_bootstrap_equals_jax(loop):
    tmp, _ = loop
    clock = FakeClock()
    with on_fake_clock(clock):
        ours, ref = _pair(tmp, clock)
        try:
            for frame in _replay_frames():
                ours.mapper.process_segmentation_tracks(*frame)
                ref.mapper.process_segmentation_tracks(*frame)
            moving = {"state": {"completed_laps": 1, "speed_kmh": 20.0}}
            stopped = {"state": {"completed_laps": 1, "speed_kmh": 0.5}}
            for agent in (ours, ref):
                assert agent._is_mapping_laps_completed(moving)
                np.testing.assert_array_equal(agent._finalise_mapping(moving), [0.0, 1.0, 0.0])
                assert agent._is_mapping, "saved while still moving"
                np.testing.assert_array_equal(agent._finalise_mapping(stopped), [0.0, 1.0, 0.0])
                assert not agent._is_mapping and agent.mapper.map_built
            for stem in ("ours", "jax"):
                assert (tmp / f"{stem}.npy").exists() and (tmp / f"{stem}-raw-points.npy").exists()
            got = np.load(tmp / "ours.npy", allow_pickle=True).item()
            want = np.load(tmp / "jax.npy", allow_pickle=True).item()
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-9, err_msg=key)

            assert ours.controller.is_mapping
            ours._maybe_setup_racing()
            ref._maybe_setup_racing()
            assert ours._is_racing_setup and not ours.controller.is_mapping
            assert ours.controller.mpc is ours.controller.racing_mpc
            centre = load_track_map(tmp / "ours.npy", device="cpu").centre
            assert abs(len(ours.reference_speeds) - len(centre)) <= 2
            np.testing.assert_allclose(ours.reference_speeds, ref.reference_speeds, **SPEED_TOL)
        finally:
            ours.teardown()
            ref.teardown()


def test_missing_map_raises_at_racing_bootstrap(loop):
    tmp, _ = loop
    cfg, _ = configs(str(tmp / "no_such_map.npz"))
    agent = Agent(cfg, use_oracle_perception=True, device="cpu")
    try:
        with pytest.raises(FileNotFoundError):
            agent._maybe_setup_racing()
    finally:
        agent.teardown()


@pytest.mark.slow
def test_mapping_laps_build_map_then_racing_bootstrap(tmp_path):
    """tests/test_mapping_e2e.py on the port: one free-running mapping lap
    with the threads running, the map built and saved, then racing on it."""
    tm = small_loop_map()
    self_map = str(tmp_path / "selfmap.npy")
    cfg, _ = configs(self_map, mapping=True)
    sim = SyntheticSimulator(
        TrackMap(tm.centre, tm.left, tm.right), CameraInfo.from_config(cfg.perception),
        dt=0.05, start_index=10, half_width=5.0,
    )
    agent = Agent(cfg, sim, use_oracle_perception=True, device="cpu")
    try:
        obs = sim.reset()
        agent.behaviour(obs)
        assert agent.controller.wait_for_first_command(timeout=180)
        # the lap waits for a fresh command set every frame: the JAX test's
        # lap runs unpaced, but the port's eager perception on the CPU
        # drops most frames of an unpaced lap, and the map maker then
        # accumulates too few to span 0.6 of it
        cmd_v = agent.controller.command_version
        for _ in range(4000):
            finalising = agent._is_mapping_laps_completed(obs)
            obs = sim.step(agent.behaviour(obs))
            if agent.mapper.map_built:
                break
            if not finalising:
                cmd_v = agent.controller.wait_for_command_newer_than(cmd_v)
        assert agent.mapper.map_built, f"map never built: laps={sim.laps} d={sim.distance:.0f}"
        centre_true = tm.centre.numpy()
        centre_built = load_track_map(self_map, device="cpu").centre.numpy()
        d = np.linalg.norm(centre_built[:, None, :] - centre_true[None, :, :], axis=-1).min(axis=1)
        assert float(np.median(d)) < 2.5
        seg = np.linalg.norm(np.diff(centre_built, axis=0), axis=1).sum()
        assert seg > 0.6 * np.linalg.norm(np.diff(centre_true, axis=0), axis=1).sum()
        for _ in range(30):
            obs = sim.step(agent.behaviour(obs))
        assert agent._is_racing_setup and not agent.controller.is_mapping
        d0, offtrack = sim.distance, 0.0
        cmd_v = agent.controller.command_version
        for i in range(100):
            obs = sim.step(agent.behaviour(obs))
            if i % 4 == 3:
                cmd_v = agent.controller.wait_for_command_newer_than(cmd_v)
            offtrack = max(offtrack, float(np.linalg.norm(centre_true - sim.pose[:2], axis=1).min()))
        assert sim.distance - d0 > 20.0
        assert offtrack < 5.0
    finally:
        agent.teardown()
