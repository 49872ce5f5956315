"""Dashboard panel rendering.

Counterpart of ``acmpc_tpu/dashboard/render.py``: the semantic palette,
the BEV panel, the world map and local localisation panels and the
composite, with the same sizes, tiling and BGR colours, drawn with the
numpy primitives of ``dashboard/raster.py`` on host arrays (the server
copies the agent's device tensors to the host once a render).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from acmpc_tpu_torch.dashboard import raster

# 10-class semantic palette
SEMANTIC_PALETTE = np.array(
    [
        [0, 0, 0],        # 0 background
        [128, 128, 128],  # 1 drivable
        [50, 160, 50],    # 2 grass
        [180, 130, 70],   # 3 kerb
        [0, 0, 200],      # 4 wall
        [200, 200, 0],    # 5 sand
        [200, 0, 200],    # 6 car
        [0, 200, 200],    # 7 marking
        [100, 50, 150],   # 8 bridge
        [255, 255, 255],  # 9 other
    ],
    dtype=np.uint8,
)
PANEL_HEIGHT = 360


def render_semantics(semantics: np.ndarray) -> np.ndarray:
    return SEMANTIC_PALETTE[np.clip(semantics, 0, 9)]


def _in_view(pts: np.ndarray, size: int) -> np.ndarray:
    return pts[
        (pts[:, 0] >= 0) & (pts[:, 0] < size) & (pts[:, 1] >= 0) & (pts[:, 1] < size)
    ]


def render_bev(
    tracks: Optional[Dict],
    prediction: Optional[np.ndarray],
    size: int = 400,
    scale: float = 2.0,
) -> np.ndarray:
    """BEV panel: track polylines and the MPC prediction. Ego at
    bottom-centre, y up."""
    img = np.zeros((size, size, 3), np.uint8)

    def to_px(points):
        px = (size // 2 + points[:, 0] * scale).astype(np.int32)
        py = (size - 20 - points[:, 1] * scale).astype(np.int32)
        return np.stack([px, py], axis=1)

    def draw(points, colour):
        if points is None or len(points) == 0:
            return
        points = np.asarray(points)
        points = points[np.isfinite(points).all(axis=1)]
        if len(points) == 0:
            return
        raster.fill_circles(img, _in_view(to_px(points), size), 1, colour)

    if tracks is not None:
        draw(tracks.get("left"), (255, 160, 60))
        draw(tracks.get("right"), (60, 160, 255))
        draw(tracks.get("centre"), (120, 255, 120))
    draw(prediction, (0, 0, 255))
    raster.draw_marker(img, (size // 2, size - 20), (255, 255, 255), raster.MARKER_TRIANGLE_UP, 10)
    return img


def render_world_map(
    map_polylines: Optional[Dict],
    particles: Optional[np.ndarray],
    estimate: Optional[np.ndarray],
    car_pose: Optional[np.ndarray],
    size: int = 400,
) -> np.ndarray:
    """World panel: track map, particle cloud and estimate."""
    img = np.zeros((size, size, 3), np.uint8)
    if map_polylines is None:
        return img
    centre = np.asarray(map_polylines["centre"])
    lo = centre.min(axis=0)
    hi = centre.max(axis=0)
    span = max(float((hi - lo).max()), 1e-6)
    pad = 20

    def to_px(points):
        p = (np.asarray(points) - lo) / span
        px = (pad + p[:, 0] * (size - 2 * pad)).astype(np.int32)
        py = (size - pad - p[:, 1] * (size - 2 * pad)).astype(np.int32)
        return np.stack([px, py], axis=1)

    for key, colour in [("left", (90, 90, 90)), ("right", (90, 90, 90)), ("centre", (50, 120, 50))]:
        if key in map_polylines:
            pts = _in_view(to_px(map_polylines[key])[::4], size)
            img[pts[:, 1], pts[:, 0]] = colour
    if particles is not None and len(particles):
        raster.fill_circles(img, _in_view(to_px(particles[:, :2]), size), 1, (0, 200, 200))
    if estimate is not None:
        x, y = to_px(estimate[None, :2])[0]
        raster.draw_marker(img, (x, y), (0, 0, 255), raster.MARKER_CROSS, 12, 2)
    if car_pose is not None:
        raster.fill_circles(img, to_px(car_pose[None, :2]), 4, (255, 255, 255))
    return img


def render_local_localisation(
    map_polylines: Optional[Dict],
    particles: Optional[np.ndarray],
    estimate: Optional[np.ndarray],
    car_pose: Optional[np.ndarray],
    window_m: float = 80.0,
    size: int = 400,
) -> np.ndarray:
    """Local localisation panel: the particle cloud and estimate over the
    map, zoomed to a window around the best estimate (or the car)."""
    img = np.zeros((size, size, 3), np.uint8)
    anchor = None
    if estimate is not None:
        anchor = np.asarray(estimate[:2], float)
    elif car_pose is not None:
        anchor = np.asarray(car_pose[:2], float)
    elif particles is not None and len(particles):
        anchor = np.asarray(particles[:, :2], float).mean(axis=0)
    if anchor is None or map_polylines is None:
        return img

    scale = size / (2.0 * window_m)

    def to_px(points):
        p = (np.asarray(points)[:, :2] - anchor) * scale
        px = (size // 2 + p[:, 0]).astype(np.int32)
        py = (size // 2 - p[:, 1]).astype(np.int32)
        return np.stack([px, py], axis=1)

    for key, colour in [
        ("left", (130, 130, 130)),
        ("right", (130, 130, 130)),
        ("centre", (60, 160, 60)),
    ]:
        if key in map_polylines:
            pts = _in_view(to_px(map_polylines[key]), size)
            img[pts[:, 1], pts[:, 0]] = colour
    if particles is not None and len(particles):
        raster.fill_circles(img, _in_view(to_px(particles), size), 1, (0, 200, 200))
    if estimate is not None:
        raster.draw_marker(img, (size // 2, size // 2), (0, 0, 255), raster.MARKER_CROSS, 14, 2)
    if car_pose is not None:
        raster.fill_circles(img, _in_view(to_px(np.asarray(car_pose)[None, :2]), size), 4, (255, 255, 255))
    return img


def compose_dashboard(panels: Dict[str, np.ndarray], width: int = 1280) -> np.ndarray:
    """Tile named panels into one frame with labels: each panel resized to
    a height of 360, rows filled up to ``width``."""
    tiles = []
    for name, panel in panels.items():
        if panel is None:
            continue
        p = panel
        if p.ndim == 2:
            p = np.repeat(p[..., None], 3, axis=2)
        if p.dtype != np.uint8:
            p = np.clip(p, 0, 255).astype(np.uint8)
        h = PANEL_HEIGHT
        w = int(p.shape[1] * h / p.shape[0])
        p = raster.resize_linear(p, w, h)
        raster.draw_label(p, name, (8, 24), (255, 255, 255))
        tiles.append(p)
    if not tiles:
        return np.zeros((PANEL_HEIGHT, width, 3), np.uint8)
    rows = []
    row: list = []
    used = 0
    for t in tiles:
        if used + t.shape[1] > width and row:
            rows.append(row)
            row, used = [], 0
        row.append(t)
        used += t.shape[1]
    rows.append(row)
    out_rows = []
    for row in rows:
        h = max(t.shape[0] for t in row)
        padded = [np.pad(t, ((0, h - t.shape[0]), (0, 0), (0, 0))) for t in row]
        strip = np.concatenate(padded, axis=1)
        if strip.shape[1] < width:
            strip = np.pad(strip, ((0, 0), (0, width - strip.shape[1]), (0, 0)))
        out_rows.append(strip[:, :width])
    return np.concatenate(out_rows, axis=0)
