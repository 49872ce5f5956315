"""Track-limit extraction: drivable mask -> left/right boundaries -> BEV
centreline, on the device.

Counterpart of ``acmpc_tpu/perception/tracks.py``: keep the drivable run
chain connected to the vehicle and take each row's leftmost and
rightmost column of it (``chain_edges``, one CUDA kernel launch of
``ops/track_chain.py`` a frame), project them to the ground
through the camera homography, crop to the BEV field of view, and fit a
weighted degree-2 polynomial x = p(y) to each boundary and to their
midline. Every step is fixed-shape: rows with no track carry a zero
weight into the fit instead of being dropped, and nothing is read back
to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.device import resolve_device
# scan_rows and row_edge_columns are also this module's API, as in the JAX package
from acmpc_tpu_torch.ops.track_chain import chain_edges, row_edge_columns, scan_rows  # noqa: F401
from acmpc_tpu_torch.perception.camera import CameraInfo

# BEV field of view crop
BEV_X_MAX = 50.0
BEV_X_MIN = -50.0
BEV_Y_MAX = 150.0
BEV_Y_MIN = 0.0
N_ORIGIN_STUB = 10  # origin stub points prepended to the centreline


@dataclasses.dataclass(frozen=True)
class TrackExtractionConfig:
    image_width: int
    image_height: int
    n_polyfit_points: int
    n_rows_to_remove_bonnet: int
    track_width_if_missing: float = 9.0
    # isolate the vehicle-connected run chain before edge extraction
    connected_runs: bool = True
    # rows per connectivity-scan step (see select_vehicle_connected_runs)
    connectivity_band: int = 4

    @classmethod
    def from_config(cls, cfg: PerceptionConfig) -> "TrackExtractionConfig":
        return cls(
            image_width=cfg.image_width,
            image_height=cfg.image_height,
            n_polyfit_points=cfg.n_polyfit_points,
            n_rows_to_remove_bonnet=cfg.n_rows_to_remove_bonnet,
        )


def select_vehicle_connected_runs(
    mask: torch.Tensor,
    bonnet_row: int,
    gap_tolerance: int = 3,
    band: int = 1,
) -> torch.Tensor:
    """Keep only the drivable run chain vertically connected to the
    vehicle: seeded on the runs of the lowest usable row that touch the
    central third, each row up keeping the runs that overlap the
    previous selection, ended by a break of more than ``gap_tolerance``
    rows (see ``ops/track_chain.py``). Returns a 0/1 mask of ``mask``'s
    dtype; the input mask when nothing was selected.

    ``band > 1`` runs the scan on the OR of each ``band``-row block (the
    scan's step count divided by ``band``) and ANDs the block selection
    back with the full-resolution mask; the gap tolerance rounds to whole
    bands. The selected mask of ``chain_edges``: one kernel launch on
    the card."""
    return chain_edges(mask, bonnet_row, gap_tolerance, band, return_mask=True)[3]


def _edge_validity(cols, rows, row_valid, cfg: TrackExtractionConfig):
    """Drop columns touching the image edge and rows at or below the
    bonnet line."""
    return (
        row_valid
        & (cols != 0)
        & (cols != cfg.image_width - 1)
        & (rows < cfg.n_rows_to_remove_bonnet)
    )


def _image_to_ground(cols, rows, homography_i2w: torch.Tensor):
    pts = torch.stack(
        [cols.to(torch.float32), rows.to(torch.float32), torch.ones_like(cols, dtype=torch.float32)],
        dim=0,
    )
    g = homography_i2w @ pts
    return (g[:2] / g[2]).T  # (H, 2) ground xy


def _bev_fov_mask(points, valid):
    return (
        valid
        & (points[:, 0] > BEV_X_MIN)
        & (points[:, 0] < BEV_X_MAX)
        & (points[:, 1] > BEV_Y_MIN)
        & (points[:, 1] < BEV_Y_MAX)
    )


def _linspace(start, stop, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` on fp32 endpoints that may be device scalars:
    start (1 - i/div) + stop i/div, with the end point exact; nothing is
    read back."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start[None]
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


def masked_polyfit_track(points, weights, n_out: int):
    """Weighted degree-2 polyfit x = p(y): evaluate on 500 points over
    [0, y_max], restart from the sample closest to the origin (the first
    on a tie), then emit ``n_out`` points to y_max. The straight stub
    (0, 0) -> (0.1, 2) when no point is valid."""
    device = points.device
    y = points[:, 1]
    x = points[:, 0]
    w = weights.to(torch.float32)
    any_valid = torch.sum(w) > 0

    y_max = torch.max(torch.where(weights, y, -torch.inf))
    y_max = torch.where(any_valid, y_max, 0.0)

    # weighted least squares for x = a y^2 + b y + c
    V = torch.stack([y**2, y, torch.ones_like(y)], dim=1)
    Vw = V * w[:, None]
    G = V.T @ Vw + 1e-6 * torch.eye(3, device=device)
    rhs = Vw.T @ x
    # solve_ex: no error check, so no read back of LAPACK's info
    coef = torch.linalg.solve_ex(G, rhs[:, None])[0][:, 0]

    y500 = _linspace(0.0, y_max, 500, device)
    x500 = coef[0] * y500**2 + coef[1] * y500 + coef[2]
    start = torch.argmin(x500**2 + y500**2)
    y_start = y500[start]

    y_new = _linspace(y_start, y_max, n_out, device)
    x_new = coef[0] * y_new**2 + coef[1] * y_new + coef[2]
    fitted = torch.stack([x_new, y_new], dim=1)

    stub = torch.stack(
        [_linspace(0.0, 0.1, n_out, device), _linspace(0.0, 2.0, n_out, device)], dim=1
    )
    return torch.where(any_valid, fitted, stub)


class TrackLimitExtractor:
    """Device-side mask -> {left, right, centre} BEV polylines. Construct
    once per (config, camera); call ``extract``."""

    def __init__(
        self,
        cfg: TrackExtractionConfig,
        camera: CameraInfo,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.camera = camera
        self.device = resolve_device(device)
        self._h_i2w = torch.tensor(camera.homography_i2w, dtype=torch.float32, device=self.device)

    def extract(self, mask: torch.Tensor) -> dict:
        """mask: (H, W) drivable 0/1 on the extractor's device. Returns
        (n_polyfit_points, 2) BEV polylines plus the raw masked boundary
        points for localisation."""
        cfg = self.cfg
        rows = torch.arange(mask.shape[0], device=mask.device)
        if cfg.connected_runs:
            # the connected run chain and its row edges, one launch
            left_cols, right_cols, row_valid = chain_edges(
                mask, cfg.n_rows_to_remove_bonnet, band=cfg.connectivity_band
            )
        else:
            left_cols, right_cols, row_valid = row_edge_columns(mask)

        left_valid = _edge_validity(left_cols, rows, row_valid, cfg)
        right_valid = _edge_validity(right_cols, rows, row_valid, cfg)

        left_pts = _image_to_ground(left_cols, rows, self._h_i2w)
        right_pts = _image_to_ground(right_cols, rows, self._h_i2w)

        left_valid = _bev_fov_mask(left_pts, left_valid)
        right_valid = _bev_fov_mask(right_pts, right_valid)

        left = masked_polyfit_track(left_pts, left_valid, cfg.n_polyfit_points)
        right = masked_polyfit_track(right_pts, right_valid, cfg.n_polyfit_points)

        # centre = midline with an origin stub prepended before the refit
        centre_raw = (left + right) / 2.0
        stub = torch.cat(
            [
                centre_raw[0, 0].expand(N_ORIGIN_STUB, 1),
                torch.zeros((N_ORIGIN_STUB, 1), device=mask.device),
            ],
            dim=1,
        )
        centre_pts = torch.cat([stub, centre_raw], dim=0)
        centre_w = torch.ones(centre_pts.shape[0], dtype=torch.bool, device=mask.device)
        centre = masked_polyfit_track(centre_pts, centre_w, cfg.n_polyfit_points)
        return {
            "left": left,
            "right": right,
            "centre": centre,
            "left_raw": left_pts,
            "left_raw_mask": left_valid,
            "right_raw": right_pts,
            "right_raw_mask": right_valid,
        }


def maybe_interpolate_track_limit(
    left: np.ndarray, right: np.ndarray, track_width: float = 9.0
):
    """If one boundary has too few points, synthesise it from the other
    via unit normals x track width. Host-side numpy helper of the
    centreline-from-track-limits mode."""

    def synth(src, sign):
        d = np.gradient(src, axis=0)
        n = np.stack([-d[:, 1], d[:, 0]], axis=1)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(norm, 1e-9)
        return src + sign * track_width * n

    if len(left) < 5 and len(right) >= 5:
        left = synth(right, +1.0)
    elif len(right) < 5 and len(left) >= 5:
        right = synth(left, -1.0)
    return left, right
