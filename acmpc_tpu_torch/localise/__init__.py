from acmpc_tpu_torch.localise.localiser import Localiser
from acmpc_tpu_torch.localise.particle_filter import (
    PFConfig,
    PFState,
    ParticleFilter,
)
from acmpc_tpu_torch.localise.track_map import (
    TrackMap,
    load_track_map,
    nearest_point,
    save_track_map,
)

__all__ = [
    "Localiser",
    "PFConfig",
    "PFState",
    "ParticleFilter",
    "TrackMap",
    "load_track_map",
    "nearest_point",
    "save_track_map",
]
