"""Vehicle geometry and steering data (pure Python).

Own copy of ``acmpc_tpu/dynamics/vehicle.py``: the port imports nothing
of the JAX package. Wheelbase, width and steering limits are typed
config with defaults for the reference car, overridable per track config.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Static vehicle geometry used by the dynamics."""

    name: str = "audi_r8_lms_2016"
    wheelbase: float = 2.650  # m
    width: float = 1.940  # m
    max_steering_deg: float = 360.0  # steering-wheel lock-to-lock half angle
    steering_ratio: float = 13.0  # wheel angle -> road-wheel angle

    @property
    def max_steering_angle(self) -> float:
        """Maximum road-wheel angle in radians."""
        return math.radians(self.max_steering_deg) / self.steering_ratio

    @property
    def margin(self) -> float:
        """Half width: the lateral safety margin of the track-limit
        constraints."""
        return self.width / 2.0

    def steering_angle(self, normalised_input: float) -> float:
        """Road-wheel angle (rad) for a normalised [-1, 1] steering input."""
        return normalised_input * self.max_steering_angle

    def normalised_input(self, steering_angle: float) -> float:
        """Inverse of :meth:`steering_angle`."""
        return steering_angle / self.max_steering_angle

    @classmethod
    def from_config(cls, cfg: dict | None) -> "VehicleParams":
        if not cfg:
            return cls()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})
