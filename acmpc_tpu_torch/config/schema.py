"""Typed configuration for the port's slice of the stack.

Counterpart of ``acmpc_tpu/config/schema.py``: the vehicle, the
perception and localisation blocks, the racing and mapping control
blocks, the map speed-profile limits, the mapping session, the actuator
PIDs and the dataset capture of a track YAML, parsed once into frozen
dataclasses. The YAML is read by the port's own subset parser
(``yaml_subset.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib

from acmpc_tpu_torch.config.yaml_subset import parse_yaml
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig


@dataclasses.dataclass(frozen=True)
class PIDConfig:
    proportional: float
    integral: float
    derivative: float
    sampling_interval_s: float

    @classmethod
    def from_config(cls, cfg: dict) -> "PIDConfig":
        return cls(
            proportional=cfg["proportional"],
            integral=cfg["integral"],
            derivative=cfg["derivative"],
            sampling_interval_s=cfg["sampling_interval_s"],
        )


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
    # the segmenter (perception/segmentation.ARCHITECTURES: fpn_resnet18,
    # segformer_b2, mask2former_r50, mask2former_swin_l); the port's own
    # key: the JAX package runs the FPN alone
    architecture: str = "fpn_resnet18"

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
            architecture=cfg.get("architecture", "fpn_resnet18"),
        )


@dataclasses.dataclass(frozen=True)
class LocalisationConfig:
    use_localisation: bool
    n_particles: int
    n_converged_particles: int
    sampling_noise_xy: float
    sampling_noise_yaw_deg: float
    control_noise_velocity: float
    control_noise_yaw_deg: float
    threshold_offset: float
    threshold_rotation_deg: float
    threshold_minimum_particles: int
    threshold_track_limit: float
    score_mean: float
    score_sigma: float
    convergence_max_distance: float
    convergence_max_angle_deg: float
    collect_benchmark_observations: bool = False
    benchmark_observations_save_location: str = "data/localisation"
    # optional keys, with the defaults of a config that omits them (what
    # each does: localise/particle_filter.py, PFConfig)
    # score_distribution: adaptive, sigma_min, sharpen_spread_m, centreline
    adaptive_sigma: bool = True
    sigma_min: float = 0.5
    sharpen_spread_m: float = 150.0
    score_centreline: bool = False
    # seeding: from_observation (off: measured to cost accuracy), ...
    seed_from_observation: bool = False
    seed_max_candidates: int = 4096
    seed_sigma: float = 5.0
    seed_uniform_fraction: float = 0.2
    seed_scan_frames: int = 8
    # convergence_criteria: maximum_fit_error (0 disables the fit gate),
    # mass_fraction (0: every valid particle must lie within the bounds)
    localised_max_error: float = 0.0
    convergence_mass: float = 0.97
    # score_distribution: sharpen_mass
    sharpen_mass: float = 0.8
    # observation: forward_limit (m), max_points per boundary
    observation_forward_limit: float = 50.0
    max_observation_points: int = 256

    @classmethod
    def from_config(cls, cfg: dict) -> "LocalisationConfig":
        return cls(
            use_localisation=cfg["use_localisation"],
            n_particles=cfg["n_particles"],
            n_converged_particles=cfg["n_converged_particles"],
            sampling_noise_xy=cfg["sampling_noise"]["x"],
            sampling_noise_yaw_deg=cfg["sampling_noise"]["yaw"],
            control_noise_velocity=cfg["control_noise"]["velocity"],
            control_noise_yaw_deg=cfg["control_noise"]["yaw"],
            threshold_offset=cfg["thresholds"]["offset"],
            threshold_rotation_deg=cfg["thresholds"]["rotation"],
            threshold_minimum_particles=cfg["thresholds"]["minimum_particles"],
            threshold_track_limit=cfg["thresholds"]["track_limit"],
            score_mean=cfg["score_distribution"]["mean"],
            score_sigma=cfg["score_distribution"]["sigma"],
            adaptive_sigma=cfg["score_distribution"].get("adaptive", True),
            sigma_min=cfg["score_distribution"].get("sigma_min", 0.5),
            sharpen_spread_m=cfg["score_distribution"].get(
                "sharpen_spread_m", 150.0
            ),
            sharpen_mass=cfg["score_distribution"].get("sharpen_mass", 0.8),
            score_centreline=cfg["score_distribution"].get(
                "centreline", False
            ),
            convergence_max_distance=cfg["convergence_criteria"][
                "maximum_distance"
            ],
            convergence_max_angle_deg=cfg["convergence_criteria"][
                "maximum_angle"
            ],
            localised_max_error=cfg["convergence_criteria"].get(
                "maximum_fit_error", 0.0
            ),
            convergence_mass=cfg["convergence_criteria"].get(
                "mass_fraction", 0.97
            ),
            seed_from_observation=cfg.get("seeding", {}).get(
                "from_observation", False
            ),
            seed_max_candidates=cfg.get("seeding", {}).get(
                "max_candidates", 4096
            ),
            seed_sigma=cfg.get("seeding", {}).get("sigma", 5.0),
            seed_uniform_fraction=cfg.get("seeding", {}).get(
                "uniform_fraction", 0.2
            ),
            seed_scan_frames=cfg.get("seeding", {}).get("scan_frames", 8),
            observation_forward_limit=cfg.get("observation", {}).get(
                "forward_limit", 50.0
            ),
            max_observation_points=cfg.get("observation", {}).get(
                "max_points", 256
            ),
            collect_benchmark_observations=cfg.get(
                "collect_benchmark_observations", False
            ),
            benchmark_observations_save_location=cfg.get(
                "benchmark_observations_save_location", "data/localisation"
            ),
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
    localisation: LocalisationConfig
    mapping_control: MPCConfig
    racing_control: MPCConfig
    map_speed_profile: MapSpeedProfileConstraints
    map_path: str
    create_map: bool
    n_mapping_laps: int
    throttle_pid: PIDConfig
    brake_pid: PIDConfig
    steering_pid: PIDConfig
    # dataset capture (the data_collection block: collect_images frames
    # saved by recording/recorder.py)
    collect_images: int = 0
    data_collection_path: str = "data"

    @classmethod
    def from_config(cls, cfg: dict) -> "AgentConfig":
        msp = cfg["racing"]["map_speed_profile_constraints"]
        dc = cfg.get("data_collection", {}) or {}
        return cls(
            experiment=cfg["experiment"],
            seed=cfg.get("seed", 0),
            vehicle=VehicleParams.from_config(cfg.get("vehicle")),
            perception=PerceptionConfig.from_config(cfg["perception"]),
            localisation=LocalisationConfig.from_config(cfg["localisation"]),
            mapping_control=MPCConfig.from_config(cfg["mapping"]["control"]),
            racing_control=MPCConfig.from_config(cfg["racing"]["control"]),
            map_speed_profile=MapSpeedProfileConstraints(
                ay_max=msp["ay_max"], a_min=msp["a_min"]
            ),
            map_path=cfg["mapping"]["map_path"],
            create_map=cfg["mapping"].get("create_map", False),
            n_mapping_laps=cfg["mapping"].get("n_mapping_laps", 2),
            throttle_pid=PIDConfig.from_config(cfg["pids"]["throttle"]),
            brake_pid=PIDConfig.from_config(cfg["pids"]["brake"]),
            steering_pid=PIDConfig.from_config(cfg["pids"]["steering"]),
            collect_images=int(dc.get("collect_images", 0)),
            data_collection_path=dc.get("save_path", "data"),
        )


def load_raw(path: str | pathlib.Path) -> dict:
    return parse_yaml(pathlib.Path(path).read_text())


def load_config(path: str | pathlib.Path) -> AgentConfig:
    return AgentConfig.from_config(load_raw(path))
