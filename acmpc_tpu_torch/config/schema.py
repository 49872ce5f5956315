"""Typed configuration for the port's slice of the stack.

Counterpart of the control part of ``acmpc_tpu/config/schema.py``: the
vehicle, the racing and mapping control blocks and the map speed-profile
limits of a track YAML, parsed once into frozen dataclasses. The YAML is
read by the port's own subset parser (``yaml_subset.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib

from acmpc_tpu_torch.config.yaml_subset import parse_yaml
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig


@dataclasses.dataclass(frozen=True)
class MapSpeedProfileConstraints:
    ay_max: float
    a_min: float


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    experiment: str
    seed: int
    vehicle: VehicleParams
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
