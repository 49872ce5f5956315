"""Simulator-observation adapter (host numpy), the port's copy of
``acmpc_tpu/perception/observations.py``: normalises the raw observation
dict of the sim interface into the agent-facing keys: speed from the
velocity vector, heading wrapped to (-pi, pi] with the pi/2 offset,
lap and sector timing passed through.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from acmpc_tpu_torch.utils.radians import convert_radians_to_plus_minus_pi


class ObservationDict(dict):
    def __init__(self, obs: Dict, *args, **kw):
        super().__init__(*args, **kw)
        self._setup(obs)

    def get_images(self) -> List[np.ndarray]:
        return [self["CameraFrontRGB"]]

    def add_segmentation_masks(self, masks: np.ndarray):
        self["CameraFrontSegm"] = masks[0]

    def _setup(self, obs: Dict):
        self["is_image_stale"] = obs.get("is_image_stale", False)
        self["CameraFrontRGB"] = obs["image"]
        pose = self._unpack_pose(obs["state"])
        self["speed"] = pose["velocity"]
        self["full_pose"] = pose
        for key in (
            "i_current_time",
            "i_best_time",
            "i_last_time",
            "current_sector_index",
            "completed_laps",
            "last_sector_time",
        ):
            self[key] = obs["state"].get(key, 0)

    @staticmethod
    def _unpack_pose(state: Dict) -> Dict:
        velocity = float(
            np.sqrt(
                state["velocity_x"] ** 2
                + state["velocity_y"] ** 2
                + state["velocity_z"] ** 2
            )
        )
        return {
            "SteeringRequest": state["steering_angle"],
            "GearRequest": float(state.get("gear", 0)),
            "velocity": velocity,
            "vx": state["velocity_x"],
            "vy": state["velocity_y"],
            "vz": state["velocity_z"],
            "ax": state.get("acceleration_g_X", 0.0),
            "ay": state.get("acceleration_g_Y", 0.0),
            "az": state.get("acceleration_g_Z", 0.0),
            "avx": state.get("local_angular_velocity_X", 0.0),
            "avy": state.get("local_angular_velocity_Y", 0.0),
            "avz": state.get("local_angular_velocity_Z", 0.0),
            "yaw": convert_radians_to_plus_minus_pi(state["heading"]),
            "pitch": state.get("pitch", 0.0),
            "roll": state.get("roll", 0.0),
            "x": state["ego_location_x"],
            "y": state["ego_location_y"],
            "z": state.get("ego_location_z", 0.0),
            "translation_yaw": state["heading"],
        }
