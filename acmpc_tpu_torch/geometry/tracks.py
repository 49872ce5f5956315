"""Synthetic track windows for tests and the on-card smoke run (numpy).

Own copy of ``acmpc_tpu/geometry/tracks.py``: hairpin, curve, chicane and
straight families, each a ``(2, N)`` array of x/y points, optionally
rotated; :func:`offset_boundaries` for closed test circuits; and
:func:`battery`, the fixed window set of the golden-control fixture.
"""

from __future__ import annotations

import numpy as np


def rotate_track_points(x: np.ndarray, y: np.ndarray, angle: float) -> np.ndarray:
    rot = np.array(
        [[np.cos(angle), np.sin(angle)], [-np.sin(angle), np.cos(angle)]]
    )
    return rot @ np.stack([x, y])


def get_hairpin_track(radius: float, n_points: int, angle: float = 0.0) -> np.ndarray:
    theta = np.linspace(0.0, 1.5 * np.pi, n_points)
    return rotate_track_points(
        np.cos(theta) * radius - radius, np.sin(theta) * radius, angle
    )


def get_curved_track(coeff: float, n_points: int, angle: float = 0.0) -> np.ndarray:
    x = np.linspace(0.0, 100.0, n_points)
    return rotate_track_points(x, coeff * x**2, angle)


def get_chicane_track(
    distance_to_chicane: float,
    chicane_width: float,
    n_points: int,
    angle: float = 0.0,
) -> np.ndarray:
    y = np.linspace(0.0, 100.0, n_points)
    x = chicane_width / (1.0 + np.exp(-0.1 * (y - distance_to_chicane)))
    return rotate_track_points(x, y, angle)


def get_straight_track(length: float, n_points: int, angle: float = 0.0) -> np.ndarray:
    return rotate_track_points(
        np.zeros(n_points), np.linspace(0.0, length, n_points), angle
    )


def with_widths(track_xy: np.ndarray, width_near: float = 10.0, width_far: float = 6.0) -> np.ndarray:
    """Attach a linearly tapering width column: returns (N, 3)
    ``[x, y, width]``, the layout the MPC takes."""
    n = track_xy.shape[1]
    widths = np.linspace(width_near, width_far, n)
    return np.stack([track_xy[0], track_xy[1], widths]).T


def offset_boundaries(centre: np.ndarray, half_width: float):
    """Left/right boundary polylines offset along a closed centreline's
    unit normals (left = +90 degrees from the direction of travel)."""
    d = np.roll(centre, -1, axis=0) - centre
    t = d / np.linalg.norm(d, axis=1, keepdims=True)
    n = np.stack([-t[:, 1], t[:, 0]], axis=1)
    return centre + half_width * n, centre - half_width * n


def battery(horizon: int) -> dict[str, np.ndarray]:
    """The five windows of the golden-control fixture
    (``tests/fixtures/golden_controls.npz``), each (horizon, 3)."""
    return {
        "hairpin_r30": with_widths(get_hairpin_track(30.0, horizon)),
        "hairpin_r60": with_widths(get_hairpin_track(60.0, horizon)),
        "chicane": with_widths(get_chicane_track(40.0, 10.0, horizon)),
        "curve": with_widths(get_curved_track(0.002, horizon, angle=-np.pi / 2)),
        "straight": with_widths(get_straight_track(200.0, horizon)),
    }
