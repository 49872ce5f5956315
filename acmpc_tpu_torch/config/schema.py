"""Typed configuration for the port's slice of the stack.

Counterpart of the control and perception parts of
``acmpc_tpu/config/schema.py``: the vehicle, the perception block, the
racing and mapping control blocks and the map speed-profile limits of a
track YAML, parsed once into frozen dataclasses. The YAML is read by the
port's own subset parser (``yaml_subset.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib

from acmpc_tpu_torch.config.yaml_subset import parse_yaml
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig


@dataclasses.dataclass(frozen=True)
class PerceptionConfig:
    model_path: str
    precision: str
    image_width: int
    image_height: int
    n_polyfit_points: int
    n_rows_to_remove_bonnet: int
    centerline_from_track_limits: bool
    vertical_fov_deg: float
    camera_position: tuple
    camera_pitch_deg: float

    @classmethod
    def from_config(cls, cfg: dict) -> "PerceptionConfig":
        return cls(
            model_path=cfg["model_path"],
            precision=cfg.get("precision", "bf16"),
            image_width=cfg["image_width"],
            image_height=cfg["image_height"],
            n_polyfit_points=cfg["n_polyfit_points"],
            n_rows_to_remove_bonnet=cfg["n_rows_to_remove_bonnet"],
            centerline_from_track_limits=cfg.get(
                "centerline_from_track_limits", False
            ),
            vertical_fov_deg=cfg["vertical_fov_deg"],
            camera_position=tuple(cfg["camera_position"]),
            camera_pitch_deg=cfg["camera_pitch_deg"],
        )


@dataclasses.dataclass(frozen=True)
class MapSpeedProfileConstraints:
    ay_max: float
    a_min: float


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    experiment: str
    seed: int
    vehicle: VehicleParams
    perception: PerceptionConfig
    mapping_control: MPCConfig
    racing_control: MPCConfig
    map_speed_profile: MapSpeedProfileConstraints

    @classmethod
    def from_config(cls, cfg: dict) -> "AgentConfig":
        msp = cfg["racing"]["map_speed_profile_constraints"]
        return cls(
            experiment=cfg["experiment"],
            seed=cfg.get("seed", 0),
            vehicle=VehicleParams.from_config(cfg.get("vehicle")),
            perception=PerceptionConfig.from_config(cfg["perception"]),
            mapping_control=MPCConfig.from_config(cfg["mapping"]["control"]),
            racing_control=MPCConfig.from_config(cfg["racing"]["control"]),
            map_speed_profile=MapSpeedProfileConstraints(
                ay_max=msp["ay_max"], a_min=msp["a_min"]
            ),
        )


def load_raw(path: str | pathlib.Path) -> dict:
    return parse_yaml(pathlib.Path(path).read_text())


def load_config(path: str | pathlib.Path) -> AgentConfig:
    return AgentConfig.from_config(load_raw(path))
