from acmpc_tpu_torch.localise.track_map import (
    TrackMap,
    load_track_map,
    nearest_point,
    save_track_map,
)

__all__ = ["TrackMap", "load_track_map", "nearest_point", "save_track_map"]
