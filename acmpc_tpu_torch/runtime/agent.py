"""The agent orchestrator: the racing brain wiring every subsystem.

Counterpart of ``acmpc_tpu/runtime/agent.py``: per-frame ``behaviour()``
with a mapping-vs-racing mode switch, perception dispatched off the hot
path, temporal command sampling and PID post-processing on it, a
localisation-gated reference speed (windowed mean of map speeds around
the estimated index), termination on stalled progress or an empty tank,
and the startup speed-profile bootstrap from the loaded map.

Threads: perception and mapping run on a worker pool, the MPC re-solve
loop is the controller's thread, localisation is advanced with the frame
and fed by perception, and every hand-off is a latest-wins mailbox. All
three threads issue their work on the device's default stream. Every
subsystem lives on the agent's device (CUDA unless the caller names
another).

One deliberate difference from the JAX agent: the localiser's predict
(frame thread) and update (perception worker) each rewrite the filter
state, and an update here is hundreds of eager launches, so one lock
serialises them: every predict and every update is applied, in call
order, and the filter's draw source is used by one thread at a time.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import AgentConfig, load_config
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.localise.benchmarking.recording import LocalisationRecorder
from acmpc_tpu_torch.localise.localiser import Localiser
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mapping.map_maker import MapMaker
from acmpc_tpu_torch.perception.observations import ObservationDict
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.recording.recorder import DataRecorder
from acmpc_tpu_torch.runtime.controller import Controller
from acmpc_tpu_torch.runtime.pid import BrakePID, SteeringPID, ThrottlePID
from acmpc_tpu_torch.runtime.sim import SimulatorInterface

MINIMUM_PROGRESS = 0.0005
MINIMUM_FUEL_L = 0.01
STALLED_FRAMES = 100  # consecutive no-progress frames before termination
REFERENCE_SPEED_WINDOW_AHEAD = 75
REFERENCE_SPEED_WINDOW_BEHIND = 25


class Agent:
    """Drive a SimulatorInterface with the full perception->MPC stack."""

    def __init__(
        self,
        cfg: AgentConfig | str,
        simulator: Optional[SimulatorInterface] = None,
        use_oracle_perception: bool = False,
        map_path: Optional[str] = None,
        device: torch.device | str | None = None,
    ):
        if isinstance(cfg, str):
            cfg = load_config(cfg)
        self.cfg = cfg
        self.simulator = simulator
        self.device = resolve_device(device)
        self._use_oracle_perception = use_oracle_perception
        self._map_path = map_path or cfg.map_path
        self._setup()

    # ------------------------------------------------------------------
    def _setup(self):
        np.random.seed(self.cfg.seed)
        self.perception = Perceiver(self.cfg.perception, device=self.device)
        # command timing rides the simulator's clock when it has one
        # (discrete-time synthetic sim: selection stays correct however
        # fast or slow the host runs); the wall clock against a real-time
        # game
        sim_clock = getattr(self.simulator, "clock", None)
        self.controller = Controller(self.cfg, clock=sim_clock, device=self.device)
        # the SAME clock drives localisation dt and benchmark-recording
        # timestamps: the particle filter integrates control over dt, and
        # the sim's ground truth advances in sim time
        self._clock = sim_clock if sim_clock is not None else time.monotonic
        self._last_localiser_step_time: Optional[float] = None
        self._throttle_pid = ThrottlePID(self.cfg.throttle_pid)
        self._brake_pid = BrakePID(self.cfg.brake_pid)
        self._steering_pid = SteeringPID(self.cfg.steering_pid)
        self.mapper = MapMaker()
        self.localiser: Optional[Localiser] = None
        # serialises the localiser's predict (frame thread) and update
        # (perception worker); see the module docstring
        self._localiser_lock = threading.Lock()
        self.reference_speeds: Optional[np.ndarray] = None
        # dataset capture (data_collection.collect_images)
        self.recorder = DataRecorder(
            self.cfg.data_collection_path, self.cfg.collect_images
        )
        # localisation benchmark capture, created at racing setup and
        # saved at teardown
        self._loc_recorder: Optional[LocalisationRecorder] = None
        self._previous_frame_time = time.monotonic()

        self.pose = {"velocity": 0.0, "steering_angle": 0.0}
        self.steering_command = 0.0
        self.acceleration_command = 0.0
        self.previous_steering_command = 0.0
        self.previous_acceleration_command = 0.0
        self._position_ring: list = []
        self._is_racing_setup = False
        self._is_mapping_setup = False
        self._last_map_update = time.monotonic()
        self._latest_tracks: Optional[Dict] = None
        self._latest_frames: Dict = {}
        self._latest_state: Dict = {}
        self.executor = ThreadPoolExecutor(max_workers=4)
        self._update_lock = threading.Lock()
        self.thread_exception = None
        # perception frames run and dropped (the worker was busy), and the
        # racing bootstrap's wall milliseconds
        self.perception_runs = 0
        self.perception_dropped = 0
        self.racing_setup_ms: Optional[float] = None
        self.controller.start()

    # -- mode switches ---------------------------------------------------
    @property
    def _is_mapping(self) -> bool:
        return self.cfg.create_map and not self.mapper.map_built

    @property
    def is_localised(self) -> bool:
        return bool(
            self.cfg.localisation.use_localisation
            and self.localiser is not None
            and self.localiser.is_localised
        )

    # -- reference speed ---------------------------------------------------
    @property
    def reference_speed(self) -> float:
        if self.is_localised and self.reference_speeds is not None:
            centre_index = self.localiser.estimated_map_index
            idx = np.arange(
                centre_index - REFERENCE_SPEED_WINDOW_BEHIND,
                centre_index + REFERENCE_SPEED_WINDOW_AHEAD,
            )
            return float(np.mean(self.reference_speeds.take(idx, mode="wrap")))
        return float(
            self.cfg.racing_control.unlocalised_max_speed
            or self.cfg.racing_control.constraints.v_max
        )

    # -- per-frame entry ---------------------------------------------------
    def behaviour(self, observation: Dict) -> np.ndarray:
        if self._is_mapping:
            if self._is_mapping_laps_completed(observation):
                return self._finalise_mapping(observation)
        else:
            self._maybe_setup_racing()
        return self.select_action(observation)

    def select_action(self, observation: Dict) -> np.ndarray:
        obs = ObservationDict(observation)
        # latest raw game state, for a dashboard to poll
        self._latest_state = observation.get("state", {})
        if self.thread_exception is not None:
            exc, self.thread_exception = self.thread_exception, None
            raise exc
        self.executor.submit(self._maybe_update_perception, obs, observation)
        self._step(obs)
        # compute THIS frame's commands before recording: the dataset's
        # (image, action) pairs must not lag by one frame
        action = self.control_input
        now = time.monotonic()
        self.recorder.maybe_record_data(
            obs,
            now - self._previous_frame_time,
            self.steering_command,
            self.acceleration_command,
        )
        self._previous_frame_time = now
        return action

    # -- perception path (worker thread) ---------------------------------
    def _maybe_update_perception(self, obs: ObservationDict, raw: Dict):
        if self._update_lock.locked():
            self.perception_dropped += 1
            return  # drop the frame: the worker is busy
        with self._update_lock:
            try:
                self._update_perception(obs, raw)
                self.perception_runs += 1
            except Exception as e:
                self.thread_exception = e

    @torch.no_grad()
    def _update_perception(self, obs: ObservationDict, raw: Dict):
        if self._use_oracle_perception and "drivable_mask" in raw:
            mask = torch.as_tensor(raw["drivable_mask"], device=self.device)
            tracks = self.perception.extractor.extract(mask)
            out = {
                "centreline": tracks["centre"],
                "left": tracks["left"],
                "right": tracks["right"],
                "left_raw": tracks["left_raw"],
                "left_raw_mask": tracks["left_raw_mask"],
                "right_raw": tracks["right_raw"],
                "right_raw_mask": tracks["right_raw_mask"],
            }
        else:
            out = self.perception.perceive(obs["CameraFrontRGB"])
        self._latest_tracks = {
            "left": out["left"].cpu().numpy(),
            "right": out["right"].cpu().numpy(),
            "centre": out["centreline"].cpu().numpy(),
        }
        # the latest raw views, kept as device tensors: a viewer does the
        # device->host copy, so headless runs never pay it
        self._latest_frames = {
            "camera": obs.get("CameraFrontRGB"),
            "segmentation": (
                raw["drivable_mask"]
                if self._use_oracle_perception and "drivable_mask" in raw
                else out["drivable"]
            ),
            "semantics": (
                None if self._use_oracle_perception else out["semantics"]
            ),
        }
        self.controller.submit_centreline(self._latest_tracks["centre"])
        self._maybe_add_observations_to_map(obs)
        if self.localiser is not None:
            mask_l = out["left_raw_mask"].cpu().numpy()
            mask_r = out["right_raw_mask"].cpu().numpy()
            left = out["left_raw"].cpu().numpy()[mask_l]
            right = out["right_raw"].cpu().numpy()[mask_r]
            with self._localiser_lock:
                self.localiser.observe_tracklimits(left, right)
            if self._loc_recorder is not None:
                self._loc_recorder.record_observation(
                    self._clock(), left, right
                )

    def _maybe_add_observations_to_map(self, obs: ObservationDict):
        if self.mapper.map_built or self._latest_tracks is None:
            return
        if not self.cfg.create_map:
            return
        # >= 0.1 s between accumulated frames, on the simulator's clock
        # where it has one (faster-than-real-time runs still accumulate a
        # full lap of frames), else the wall clock. Not the observation's
        # i_current_time: that is the lap clock, which resets each lap.
        sim_clock = getattr(self.simulator, "clock", None)
        now = sim_clock() if sim_clock is not None else time.monotonic()
        if 0.0 <= now - self._last_map_update <= 0.1:
            return
        t = self._latest_tracks
        self.mapper.process_segmentation_tracks(
            obs["full_pose"], t["left"], t["right"], t["centre"]
        )
        self._last_map_update = now

    # -- frame-rate state updates ----------------------------------------
    def _step(self, obs: ObservationDict):
        self.previous_steering_command = self.steering_command
        self.previous_acceleration_command = self.acceleration_command
        self.controller.reference_speed = self.reference_speed
        self.controller.is_localised = self.is_localised
        self.pose["velocity"] = obs["speed"]
        self.pose["steering_angle"] = obs["full_pose"]["SteeringRequest"]
        if self.localiser is not None:
            now = self._clock()
            last = self._last_localiser_step_time
            self._last_localiser_step_time = now
            with self._localiser_lock:
                self.localiser.step(
                    self.control_command,
                    dt=0.0 if last is None else now - last,
                )
            if self._loc_recorder is not None:
                fp = obs["full_pose"]
                # ground truth in the MAP frame the tracker compares
                # against (x = -game_x, y = game_z, yaw = pi/2 - heading,
                # the particle filter's world yaw)
                map_yaw = (np.pi / 2 - fp["translation_yaw"] + np.pi) % (
                    2 * np.pi
                ) - np.pi
                self._loc_recorder.record_control(
                    now,
                    self.control_command,
                    {"x": -fp["x"], "y": fp["z"], "yaw": map_yaw},
                )

    @property
    def control_command(self) -> tuple:
        return (
            self.pose["steering_angle"],
            self.previous_acceleration,
            self.pose["velocity"],
        )

    @property
    def previous_acceleration(self) -> float:
        cmd = self.previous_acceleration_command
        return cmd * 16 if cmd < 0 else cmd * 6

    # -- actuation ---------------------------------------------------------
    @property
    def control_input(self) -> np.ndarray:
        desired_velocity, desired_yaw = self.controller.desired_state
        steering_angle = self._process_yaw(desired_yaw)
        throttle, brake = self._calculate_acceleration(desired_velocity)
        self.acceleration_command = throttle if throttle > 0 else -brake
        return np.array([steering_angle, brake, throttle])

    def _process_yaw(self, yaw: float) -> float:
        max_delta = self.controller.delta_max
        target = -1.0 * np.clip(yaw / max_delta, -1, 1)
        current = self.pose["steering_angle"]
        delta_cmd = self._steering_pid(current, target)
        self.steering_command = float(np.clip(current + delta_cmd, -1, 1))
        return self.steering_command

    def _calculate_acceleration(self, target_velocity: float):
        current = self.pose["velocity"]
        return (
            self._throttle_pid(current, target_velocity),
            self._brake_pid(current, target_velocity),
        )

    # -- mapping mode ------------------------------------------------------
    def _is_mapping_laps_completed(self, observation: Dict) -> bool:
        return (
            observation["state"]["completed_laps"] >= self.cfg.n_mapping_laps
        )

    def _finalise_mapping(self, observation: Dict) -> np.ndarray:
        if observation["state"]["speed_kmh"] <= 1:
            self.mapper.save_map(self._map_path)
        return np.array([0.0, 1.0, 0.0])  # brake to a stop

    # -- racing bootstrap --------------------------------------------------
    def _maybe_setup_racing(self):
        if not self._is_racing_setup:
            self._setup_racing()

    def _setup_racing(self):
        t0 = time.perf_counter()
        track_map = load_track_map(self._map_path, device=self.device)
        self._calculate_speed_profile(track_map.centre.cpu().numpy())
        self.mapper.map_built = True
        # switch the control thread from the mapping MPC to the racing MPC
        self.controller.is_mapping = False
        if (
            self.cfg.localisation.use_localisation
            or self.cfg.localisation.collect_benchmark_observations
        ):
            self.localiser = Localiser(
                self.cfg.localisation,
                track_map,
                vehicle=self.cfg.vehicle,
                seed=self.cfg.seed,
                device=self.device,
            )
            if self.cfg.localisation.collect_benchmark_observations:
                self._loc_recorder = LocalisationRecorder(
                    self.cfg.localisation.benchmark_observations_save_location
                )
        self._is_racing_setup = True
        self.racing_setup_ms = (time.perf_counter() - t0) * 1e3

    def _calculate_speed_profile(self, centre_track: np.ndarray):
        from scipy.signal import savgol_filter

        road_width = 9.5
        track = np.stack(
            [
                centre_track[:, 0],
                centre_track[:, 1],
                np.full(len(centre_track), road_width),
            ]
        ).T
        path = self.controller.compute_track_speed_profile(track)
        velocities = path.velocities.cpu().numpy()
        self.reference_speeds = savgol_filter(velocities, 21, 3)

    # -- run loop & lifecycle ----------------------------------------------
    def termination_condition(self, observation: Dict) -> bool:
        """Stalled-progress / empty-tank termination, checked per frame:
        the car is stalled when it has covered less than MINIMUM_PROGRESS
        of the lap over the last STALLED_FRAMES frames (a ring buffer of
        positions). Comparing consecutive frames against the same
        threshold would flag a full-speed car as stalled on any track
        longer than ~v*dt/MINIMUM_PROGRESS."""
        state = observation["state"]
        position = state["normalised_car_position"]
        self._position_ring.append(position)
        if len(self._position_ring) > STALLED_FRAMES:
            self._position_ring.pop(0)
            old = self._position_ring[0]
            # wrap-aware progress over the window
            progress = abs(position - old)
            progress = min(progress, 1.0 - progress)
            stalled = progress < MINIMUM_PROGRESS
        else:
            stalled = False
        return stalled or state["fuel"] < MINIMUM_FUEL_L

    def restart_condition(self, observation: Dict) -> bool:
        """Never request a session restart: the run-loop contract reserves
        this hook for race-restart logic that is not implemented."""
        return False

    def run(self, max_steps: int = 100000, check_termination_every: int = 1):
        """Drive the simulator; termination is checked per frame."""
        assert self.simulator is not None, "no simulator attached"
        obs = self.simulator.reset()
        for step in range(max_steps):
            action = self.behaviour(obs)
            obs = self.simulator.step(action)
            if step % check_termination_every == check_termination_every - 1:
                if self.termination_condition(obs):
                    break
        self.teardown()
        return obs

    def teardown(self):
        self.controller.shutdown()
        # wait for in-flight perception work: a worker appending to the
        # recorder while save() pickles the same dict corrupts the file
        self.executor.shutdown(wait=True)
        if self._loc_recorder is not None:
            self._loc_recorder.save()
        if self.simulator is not None:
            self.simulator.close()
