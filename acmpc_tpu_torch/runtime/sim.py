"""Simulator adapter interface and a deterministic synthetic simulator.

Counterpart of ``acmpc_tpu/runtime/sim.py``, host code (numpy and a
``scipy`` kd-tree) on the port's own ``TrackMap``, ``CameraInfo`` and
``VehicleParams``: a kinematic bicycle car on a track map that renders
the ground-truth drivable mask through the camera model the perception
stack inverts, and a textured camera frame over it. From the same state
it renders the same masks and frames as the JAX package's simulator:
the same numpy generator seeding and the same bounded kd-tree query.
"""

from __future__ import annotations

import abc
from typing import Dict

import numpy as np
import torch
from scipy.spatial import cKDTree

from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.localise.track_map import TrackMap
from acmpc_tpu_torch.perception.camera import CameraInfo

BRAKE_DECEL = 16.0  # m/s^2 at full brake
THROTTLE_ACCEL = 6.0  # m/s^2 at full throttle


class SimulatorInterface(abc.ABC):
    """``reset() -> obs``, ``step(action) -> obs``.

    action = [steering, brake, throttle], normalised. obs is the raw dict
    ``ObservationDict`` understands.
    """

    @abc.abstractmethod
    def reset(self) -> Dict: ...

    @abc.abstractmethod
    def step(self, action: np.ndarray) -> Dict: ...

    def close(self):
        pass

    # Optional simulation-time source (seconds); None means the wall
    # clock (right against a real-time game).
    clock = None


class SyntheticSimulator(SimulatorInterface):
    """Kinematic bicycle car on a TrackMap, rendering the ground-truth
    drivable mask into the camera frame each step.

    Conventions:
    * world frame = map frame; car state (x, y, yaw_world, v);
    * BEV ego frame (x right, y forward): world = R(-yaw+pi/2)^T bev + pos;
    * emitted sim state uses the game's conventions: heading =
      pi/2 - yaw_world, ego_location_x = -x, ego_location_z = y.
    """

    def __init__(
        self,
        track_map: TrackMap,
        camera: CameraInfo,
        vehicle: VehicleParams | None = None,
        dt: float = 0.05,
        start_index: int = 0,
        half_width: float = 5.0,
        initial_speed: float = 10.0,
        fuel_l: float = 50.0,
        render_mask: bool = True,
    ):
        self.map = track_map
        self.camera = camera
        self.vehicle = vehicle or VehicleParams()
        self.dt = dt
        self.half_width = half_width
        self._fuel = fuel_l
        self._render_mask = render_mask

        self._centre = torch.as_tensor(track_map.centre).detach().cpu().numpy().astype(np.float64)
        self._tree = cKDTree(self._centre)
        self._n_map = len(self._centre)

        # static pixel -> ego-BEV ground grid (computed once)
        h, w = camera.height, camera.width
        ys, xs = np.mgrid[0:h, 0:w]
        pix = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
        ground = camera.image_to_ground(pix)
        self._pix_ground = ground.reshape(h, w, 2)
        # only pixels that land in front of the car within a sane range
        self._pix_usable = (
            (self._pix_ground[..., 1] > 0.5)
            & (self._pix_ground[..., 1] < 200.0)
            & (np.abs(self._pix_ground[..., 0]) < 100.0)
        )

        self._start_index = start_index
        self.reset()

    def clock(self) -> float:
        """Sim-time source for the runtime's temporal command selection."""
        return self.t

    # -- state ----------------------------------------------------------
    def reset(self) -> Dict:
        i = self._start_index
        p0 = self._centre[i]
        p1 = self._centre[(i + 1) % self._n_map]
        self.x, self.y = float(p0[0]), float(p0[1])
        self.yaw = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0]))
        self.v = 10.0
        self.steering = 0.0
        self.distance = 0.0
        self.laps = 0
        self._last_progress = self._normalised_position()
        self.t = 0.0
        self._lap_start_t = 0.0
        self._last_lap_ms = 0.0
        self._best_lap_ms = 0.0
        return self._observation()

    def _normalised_position(self) -> float:
        _, idx = self._tree.query([self.x, self.y])
        return idx / self._n_map

    # -- dynamics -------------------------------------------------------
    def step(self, action: np.ndarray) -> Dict:
        steering, brake, throttle = float(action[0]), float(action[1]), float(action[2])
        self.steering = np.clip(steering, -1.0, 1.0)
        delta = -self.steering * self.vehicle.max_steering_angle
        accel = np.clip(throttle, 0, 1) * THROTTLE_ACCEL - np.clip(
            brake, 0, 1
        ) * BRAKE_DECEL

        self.x += self.v * np.cos(self.yaw) * self.dt
        self.y += self.v * np.sin(self.yaw) * self.dt
        self.yaw += self.v * np.tan(delta) / self.vehicle.wheelbase * self.dt
        self.yaw = float((self.yaw + np.pi) % (2 * np.pi) - np.pi)
        self.v = float(np.clip(self.v + accel * self.dt, 0.0, 120.0))
        self.distance += self.v * self.dt
        self._fuel = max(0.0, self._fuel - 1e-5 * self.v * self.dt)
        self.t += self.dt

        progress = self._normalised_position()
        if progress < 0.2 and self._last_progress > 0.8:
            self.laps += 1
            self._last_lap_ms = (self.t - self._lap_start_t) * 1000
            if self._best_lap_ms <= 0 or self._last_lap_ms < self._best_lap_ms:
                self._best_lap_ms = self._last_lap_ms
            self._lap_start_t = self.t
        self._last_progress = progress
        return self._observation()

    # -- rendering ------------------------------------------------------
    def render_drivable_mask(self) -> np.ndarray:
        """Ground-truth drivable mask in the camera frame."""
        h, w = self.camera.height, self.camera.width
        mask = np.zeros((h, w), np.uint8)
        if not self._render_mask:
            return mask
        bev = self._pix_ground[self._pix_usable]  # (K, 2)
        a = -self.yaw + np.pi / 2
        rot_t = np.array(
            [[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]]
        )  # R(a)^T
        world = bev @ rot_t.T + np.array([self.x, self.y])
        # bounded query: classification only needs d < half_width, and
        # points beyond the bound return inf, classified 0 either way
        d, _ = self._tree.query(
            world, workers=-1, distance_upper_bound=self.half_width * 1.01
        )
        mask[self._pix_usable] = (d < self.half_width).astype(np.uint8)
        return mask

    def render_camera_image(self, mask: np.ndarray) -> np.ndarray:
        """Synthetic camera frame: textured asphalt / grass / sky, so a
        segmentation model trained on it must learn more than a constant
        threshold."""
        h, w = mask.shape
        rng = np.random.default_rng(int(self.t * 1000) % (2**31))
        img = np.empty((h, w, 3), np.float32)
        # grass-ish background with low-frequency mottling
        rows = np.linspace(0.0, 1.0, h)[:, None]
        mottle = rng.normal(0.0, 12.0, (h // 8 + 1, w // 8 + 1))
        mottle = np.kron(mottle, np.ones((8, 8)))[:h, :w]
        img[..., 0] = 70 + mottle
        img[..., 1] = 130 + 25 * rows + mottle
        img[..., 2] = 60 + mottle
        # asphalt where drivable: grey with speckle + centre shading
        on = mask.astype(bool)
        speckle = rng.normal(0.0, 8.0, (h, w))
        grey = 105 + 20 * rows + speckle
        for c in range(3):
            img[..., c][on] = grey[on]
        # sky above the unusable horizon rows
        sky = ~self._pix_usable
        img[..., 0][sky] = 140
        img[..., 1][sky] = 170
        img[..., 2][sky] = 220
        img += rng.normal(0.0, 3.0, (h, w, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    def _observation(self) -> Dict:
        mask = self.render_drivable_mask()
        image = self.render_camera_image(mask)
        heading = float(np.pi / 2 - self.yaw)
        state = {
            "steering_angle": self.steering,
            "gear": 3,
            "velocity_x": self.v * np.cos(self.yaw),
            "velocity_y": self.v * np.sin(self.yaw),
            "velocity_z": 0.0,
            "heading": heading,
            "ego_location_x": -self.x,
            "ego_location_y": 0.0,
            "ego_location_z": self.y,
            "speed_kmh": self.v * 3.6,
            "distance_traveled": self.distance,
            "normalised_car_position": self._normalised_position(),
            "completed_laps": self.laps,
            "fuel": self._fuel,
            # lap/sector timing, game-convention keys: i_current_time is
            # the current lap time in ms, sectors are thirds of the lap
            "i_current_time": int((self.t - self._lap_start_t) * 1000),
            "i_best_time": int(self._best_lap_ms),
            "i_last_time": int(self._last_lap_ms),
            "current_sector_index": int(self._normalised_position() * 3) % 3,
            "last_sector_time": 0,
        }
        return {
            "image": image,
            "drivable_mask": mask,  # oracle-perception shortcut for tests
            "state": state,
            "is_image_stale": False,
        }

    # ground truth for evaluation
    @property
    def pose(self) -> np.ndarray:
        return np.array([self.x, self.y, self.yaw])
