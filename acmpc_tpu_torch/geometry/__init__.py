from acmpc_tpu_torch.geometry.path import ReferencePath, construct_waypoints, wrap_to_pi
from acmpc_tpu_torch.geometry.tracks import (
    battery,
    get_chicane_track,
    get_curved_track,
    get_hairpin_track,
    get_straight_track,
    rotate_track_points,
    with_widths,
)

__all__ = [
    "ReferencePath",
    "battery",
    "construct_waypoints",
    "get_chicane_track",
    "get_curved_track",
    "get_hairpin_track",
    "get_straight_track",
    "rotate_track_points",
    "with_widths",
    "wrap_to_pi",
]
