"""The port's recorders driven by its agent, synchronously in one thread
(the JAX package's round trip, tests/test_recording_roundtrip.py, records
from the agent's worker thread and depends on its timing).

1. Dataset capture: the agent's frames go through ``DataRecorder`` as
   ``select_action`` sends them; the frames and ``commands.json`` are
   written, and the JAX package's recorder writes the same files from
   the same samples.
2. Localisation capture: the agent's ``_step`` and ``_update_perception``
   record control and observations; the saved recording replays through
   the port's ``BenchmarkLocalisation`` call for call.
"""

import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import pytest
import torch

from acmpc_tpu.recording import DataRecorder as JDataRecorder
from acmpc_tpu_torch.localise.benchmarking.benchmark import BenchmarkLocalisation
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.observations import ObservationDict
from acmpc_tpu_torch.recording import DataRecorder
from acmpc_tpu_torch.runtime import Agent
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from torch_agent_cases import ClockOnlySim, FakeClock, configs, on_fake_clock, save_asymmetric_map

FRAMES = 60
N_PARTICLES = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def recorded_run(tmp_path_factory):
    """The port's agent with localisation and both recorders on, driven
    synchronously for FRAMES frames; each frame's dataset sample is also
    given to the JAX package's recorder."""
    tmp = tmp_path_factory.mktemp("recording")
    map_path = str(tmp / "track.npz")
    save_asymmetric_map(tmp / "track.npz")
    cfg, _ = configs(
        map_path,
        use_localisation=True,
        n_particles=N_PARTICLES,
        n_converged_particles=N_PARTICLES,
        collect_benchmark_observations=True,
        benchmark_observations_save_location=str(tmp / "loc_recording"),
    )
    cfg = dataclasses.replace(cfg, collect_images=3, data_collection_path=str(tmp / "dataset"))
    jrecorder = JDataRecorder(str(tmp / "jax_dataset"), 3)
    clock = FakeClock()
    with on_fake_clock(clock):
        agent = Agent(cfg, ClockOnlySim(clock), use_oracle_perception=True, device="cpu")
        thread = agent.controller._thread
        agent.controller.shutdown()
        sim = SyntheticSimulator(
            load_track_map(map_path, device="cpu"), CameraInfo.from_config(cfg.perception),
            dt=0.05, start_index=50, half_width=5.0,
        )
        raw = sim.reset()
        agent._maybe_setup_racing()
        for k in range(FRAMES):
            clock.t = sim.t
            obs = ObservationDict(raw)
            agent._update_perception(obs, raw)
            thread._solve(*agent.controller._centreline_box.read()[0])
            agent._step(obs)
            action = agent.control_input
            sample = (obs, 0.05, agent.steering_command, agent.acceleration_command)
            agent.recorder.maybe_record_data(*sample)
            jrecorder.maybe_record_data(*sample)
            raw = sim.step(action)
        agent.teardown()
    return cfg, map_path, tmp


def test_dataset_capture_writes_frames_and_commands(recorded_run):
    _, _, tmp = recorded_run
    base = tmp / "dataset" / "datacollection"
    images = sorted(p.name for p in (base / "images").glob("*.png"))
    # the recorder stops one sample short of its count, as JAX's does
    assert images == ["CameraFrontRGB_0.png", "CameraFrontRGB_1.png"]
    commands = json.loads((base / "commands" / "commands.json").read_text())
    assert list(commands) == ["0", "1"]
    assert {"dt", "steering_angle", "acceleration", "velocity"} == set(commands["0"])
    jbase = tmp / "jax_dataset" / "datacollection"
    assert (base / "commands" / "commands.json").read_text() == (jbase / "commands" / "commands.json").read_text()
    for name in images:
        assert (base / "images" / name).read_bytes() == (jbase / "images" / name).read_bytes()


def test_recorder_writes_masks_and_tracks(tmp_path):
    """tests/test_tools.py's recorder case, on both packages."""
    obs = {
        "CameraFrontRGB": np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8),
        "CameraFrontSegm": np.eye(32, dtype=np.uint8),
        "full_pose": {"velocity": 12.0},
        "tracks": {"centre": np.ones((5, 2)), "left": np.zeros((5, 2)), "right": np.full((5, 2), 2.0)},
    }
    for cls, name in ((DataRecorder, "ours"), (JDataRecorder, "jax")):
        rec = cls(str(tmp_path / name), n_image_samples=3)
        for _ in range(3):
            rec.maybe_record_data(obs, 0.05, 0.1, 0.5)
        assert not rec.enabled  # capped
    for sub in ("images", "masks", "commands"):
        ours = sorted((tmp_path / "ours" / "datacollection" / sub).iterdir())
        ref = sorted((tmp_path / "jax" / "datacollection" / sub).iterdir())
        assert [p.name for p in ours] == [p.name for p in ref] and ours
        assert all(a.read_bytes() == b.read_bytes() for a, b in zip(ours, ref))
    maps = np.load(tmp_path / "ours" / "datacollection" / "maps" / "0.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(maps["right"], np.full((5, 2), 2.0))
    assert not DataRecorder(str(tmp_path / "off"), 0).enabled
    assert not (tmp_path / "off").exists()


def test_localisation_recording_replays_through_benchmark(recorded_run):
    cfg, map_path, tmp = recorded_run
    loc_dir = tmp / "loc_recording"
    control = np.load(loc_dir / "control.npy", allow_pickle=True).item()
    observations = np.load(loc_dir / "observations.npy", allow_pickle=True).item()
    # one control record per frame and one observation per perceived frame
    assert len(control) == FRAMES and len(observations) == FRAMES
    assert set(control[0]["game_pose"][0]) == {"x", "y", "yaw"}
    times = [control[k]["time"] for k in range(FRAMES)]
    np.testing.assert_allclose(np.diff(times), 0.05, atol=1e-9)
    bench = BenchmarkLocalisation(
        str(loc_dir), map_path,
        dataclasses.replace(cfg.localisation, collect_benchmark_observations=False),
        vehicle=cfg.vehicle, seed=0, device="cpu",
    )
    summary = bench.run()
    assert bench.tracker._n_total_steps == len(control)
    assert bench.tracker._n_total_observations == len(observations)
    assert 0.0 <= summary["percent_localised"] <= 100.0
    assert summary["n_steps"] == len(control)
    # ground truth is recorded in the map frame the tracker compares
    # against: the error is physical (the car is on a ~1.3 km loop)
    if not math.isnan(summary["mean_position_error_m"]):
        assert summary["mean_position_error_m"] < 60.0, summary
