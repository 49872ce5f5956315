"""Track-map construction from driven laps (host numpy).

Counterpart of ``acmpc_tpu/mapping/map_maker.py``: accumulate the nearest
BEV boundary point per frame, transformed into world coordinates by the
game pose; at the end of mapping order the point clouds into lap loops
(the C++ tour of ``native.py``), derive the centreline, smooth, orient,
resample at a uniform arc length and save. Savitzky-Golay smoothing is a
closed-form FIR convolution with wrap padding. Maps save as the pickled
``.npy`` dict the map loaders of both packages read, with the raw
boundary points beside it (``<stem>-raw-points.npy``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from acmpc_tpu_torch.native import tsp_tour

TRIM_STATIONARY = 30  # frames trimmed at both ends
SMOOTH_WINDOW = 15
SMOOTH_POLYORDER = 1
UPSAMPLE_DENSITY = 0.5  # metres between points after upsampling


def savgol_coefficients(window: int, polyorder: int) -> np.ndarray:
    """Closed-form Savitzky-Golay FIR coefficients (smoothing, deriv 0):
    the least-squares projection of the window onto degree-`polyorder`
    polynomials, evaluated at the centre."""
    half = window // 2
    t = np.arange(-half, half + 1, dtype=np.float64)
    V = np.vander(t, polyorder + 1, increasing=True)  # (window, p+1)
    # projection row for the centre sample: e0' (V'V)^-1 V'
    G = np.linalg.solve(V.T @ V, V.T)
    return G[0]


def savgol_wrap(
    values: np.ndarray,
    window: int = SMOOTH_WINDOW,
    polyorder: int = SMOOTH_POLYORDER,
    closed: bool = True,
) -> np.ndarray:
    """Savitzky-Golay smoothing with circular (wrap) boundary handling —
    matches scipy's mode="wrap".
    ``closed=False`` reflects at the ends instead: wrap padding on an
    OPEN arc (a trimmed mapping lap) blends the two far-apart ends into
    each other."""
    coef = savgol_coefficients(window, polyorder)
    half = window // 2
    if closed:
        padded = np.concatenate([values[-half:], values, values[:half]])
    else:
        head = 2 * values[0] - values[half:0:-1]
        tail = 2 * values[-1] - values[-2 : -half - 2 : -1]
        padded = np.concatenate([head, values, tail])
    return np.convolve(padded, coef[::-1], mode="valid")


def upsample_track(track: np.ndarray, desired_density: float = UPSAMPLE_DENSITY) -> np.ndarray:
    """Linear upsampling to ~desired_density point spacing (a
    per-segment linspace with the duplicate endpoint dropped,
    vectorised)."""
    distances = np.linalg.norm(track[1:] - track[:-1], axis=1)
    upsample = int(np.ceil(np.mean(distances) / desired_density))
    if upsample <= 1:
        return track[:-1].copy()
    t = np.linspace(0.0, 1.0, upsample)[:-1]  # (u,)
    seg = track[:-1, None, :] + t[None, :, None] * (
        track[1:, None, :] - track[:-1, None, :]
    )
    return seg.reshape(-1, 2)


def _is_closed(track: np.ndarray, factor: float = 5.0) -> bool:
    """A track is a closed loop when the end-to-start gap is comparable
    to the typical segment — after the stationary trim a mapping lap can
    be an OPEN arc, and treating it as
    closed would synthesise the closing chord as track geometry."""
    seg = np.linalg.norm(np.diff(track, axis=0), axis=1)
    gap = np.linalg.norm(track[-1] - track[0])
    return bool(gap < factor * max(float(np.median(seg)), 1e-9))


def resample_uniform(
    track: np.ndarray, spacing: float = UPSAMPLE_DENSITY
) -> np.ndarray:
    """Arc-length UNIFORM resampling of a closed track polyline.

    Per-segment upsampling (our
    ``upsample_track``) preserves whatever raggedness the ordered point
    cloud has — observation clusters leave 0.03 m segments next to 5 m
    ones, and discrete curvature (wrapped angle / ds) spikes by 1/ds at
    the clusters: a self-built 20 km map measured kappa up to 49 rad/m
    (a 2 cm radius) purely from spacing noise, which turns downstream
    window QPs physically absurd (they stall or overflow fp32). Uniform
    arc-length resampling makes the spacing — and therefore the
    curvature estimate — well-conditioned by construction.
    """
    closed = _is_closed(track)
    pts = np.vstack([track, track[:1]]) if closed else track
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = float(s[-1])
    n_out = max(int(round(total / spacing)), 8)
    si = np.linspace(0.0, total, n_out, endpoint=not closed)
    x = np.interp(si, s, pts[:, 0])
    y = np.interp(si, s, pts[:, 1])
    return np.stack([x, y], axis=1)


def remove_folds(track: np.ndarray, max_turn_rad: float = np.pi / 16) -> np.ndarray:
    """Drop points where the polyline turns sharper than ``max_turn_rad``.

    Tour ordering of noisy observation clouds occasionally leaves a FOLD
    — the path doubles back within centimetres — which survives
    smoothing (savgol contracts it into a near-duplicate kink, measured
    kappa ~80 rad/m on a self-built map). A real track at 0.5 m spacing
    turns < 0.03 rad per point (even a 25 m-radius hairpin turns 0.02),
    so anything above ~11 degrees is observation-ordering noise, not
    geometry.
    """
    for _ in range(10):  # a fold spans several points; peel until clean
        closed = _is_closed(track)
        pts = np.vstack([track, track[:1]]) if closed else track
        d = np.diff(pts, axis=0)
        psi = np.arctan2(d[:, 1], d[:, 0])
        if closed:
            turn = psi - np.roll(psi, 1)
            turn = np.abs(np.mod(turn + np.pi, 2.0 * np.pi) - np.pi)
        else:
            # open arc: endpoints have no incoming/outgoing pair
            inner = psi[1:] - psi[:-1]
            inner = np.abs(np.mod(inner + np.pi, 2.0 * np.pi) - np.pi)
            turn = np.concatenate([[0.0], inner, [0.0]])[: len(track)]
        keep = turn < max_turn_rad
        if keep.all():
            break
        track = track[keep]
    return track


def remove_near_duplicates(
    centres: np.ndarray, insides: np.ndarray, outsides: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop consecutive near-duplicate points, per track. Indexing all
    three tracks with the centre track's mask would crash whenever
    upsampling gives the boundaries different lengths (their perimeters
    differ); the tracks are not index-aligned after independent tour
    ordering anyway, so each is deduplicated against its own diffs."""

    def dedup(track: np.ndarray) -> np.ndarray:
        d = np.diff(track, axis=0)
        dists = np.hypot(d[:, 0], d[:, 1])
        keep = np.ones(len(track), bool)
        keep[1:] = dists > 1e-4
        return track[keep]

    return dedup(centres), dedup(insides), dedup(outsides)


class MapMaker:
    def __init__(self, verbose: bool = False):
        self.xy_points_driven: list = []
        self.outside_track: list = []
        self.inside_track: list = []
        self.centre_track: list = []
        self.verbose = verbose
        self.map_built = False

    # -- per-frame accumulation -----------------------------------------
    def map_world_pose_xy(self, pose: Dict):
        xy = [-pose["x"], pose["z"]]
        self.xy_points_driven.append(xy)
        return xy

    @staticmethod
    def transform_track_point(points, translation, rotation):
        return translation + (rotation.T @ points.T).T

    def process_segmentation_tracks(self, full_pose, left_track, right_track, centre_track):
        translation = self.map_world_pose_xy(full_pose)
        yaw = full_pose["translation_yaw"]
        rot = np.array(
            [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        )
        self.outside_track.append(
            self.transform_track_point(left_track, translation, rot)
        )
        self.centre_track.append(
            self.transform_track_point(centre_track, translation, rot)
        )
        self.inside_track.append(
            self.transform_track_point(right_track, translation, rot)
        )

    # -- map construction ------------------------------------------------
    @staticmethod
    def order_points(points: np.ndarray, time_bound: float = 5.0) -> np.ndarray:
        return points[tsp_tour(points, time_bound)]

    @staticmethod
    def _flatten_nearest(per_frame: list) -> np.ndarray:
        """First (nearest) BEV point of each frame."""
        return np.array([frame[0] for frame in per_frame])

    @staticmethod
    def _smooth_track(track: np.ndarray) -> np.ndarray:
        closed = _is_closed(track)
        return np.stack(
            [
                savgol_wrap(track[:, 0], closed=closed),
                savgol_wrap(track[:, 1], closed=closed),
            ],
            axis=1,
        )

    @classmethod
    def _regularise(cls, track: np.ndarray, n_passes: int = 3) -> np.ndarray:
        """Uniform-spacing, fold-free final geometry: alternate fold
        removal, smoothing and arc-length resampling until clean (see
        remove_folds / resample_uniform)."""
        track = resample_uniform(track)
        for _ in range(n_passes):
            track = resample_uniform(cls._smooth_track(remove_folds(track)))
        # finish at a fold-free fixed point: resampling across a removed
        # fold can recombine two sub-threshold turns into one above it,
        # so alternate until remove_folds is a no-op on the resampled
        # polyline (smoothing is NOT last — it can re-contract a kink)
        for _ in range(5):
            cleaned = remove_folds(track)
            converged = len(cleaned) == len(track)
            track = resample_uniform(cleaned)
            if converged:
                break
        return track

    @staticmethod
    def _calculate_centre_track(outsides: np.ndarray, insides: np.ndarray) -> np.ndarray:
        """centre = midpoint of each inside point and its nearest outside
        point. Chunked so nordschleife-
        length maps (tens of thousands of frames) don't materialise an
        n^2 distance matrix."""
        out_sq = np.sum(outsides**2, axis=1)[None, :]
        nearest = np.empty(len(insides), np.int64)
        for i in range(0, len(insides), 1024):
            block = insides[i : i + 1024]
            d2 = (
                np.sum(block**2, axis=1)[:, None]
                - 2.0 * block @ outsides.T
                + out_sq
            )
            nearest[i : i + 1024] = np.argmin(d2, axis=1)
        return MapMaker.order_points((insides + outsides[nearest]) / 2.0)

    @staticmethod
    def _earlier_points_come_before_later(ordered, raw) -> bool:
        """Direction heuristic."""
        sooner = np.linalg.norm(ordered[0] - raw[10])
        later = np.linalg.norm(ordered[5] - raw[10])
        return sooner > later

    def _maybe_flip(self, track: np.ndarray, raw_frames: list) -> np.ndarray:
        raw = self._flatten_nearest(raw_frames)
        if not self._earlier_points_come_before_later(track, raw):
            track = np.flip(track, axis=0)
        return track

    def build_map(self, insides: np.ndarray, outsides: np.ndarray) -> Dict:
        outsides = self.order_points(outsides)
        insides = self.order_points(insides)
        centres = self._calculate_centre_track(outsides, insides)

        outsides = self._smooth_track(outsides)
        centres = self._smooth_track(centres)
        insides = self._smooth_track(insides)

        outsides = self.order_points(outsides)
        centres = self.order_points(centres)
        insides = self.order_points(insides)

        if self.outside_track:
            outsides = self._maybe_flip(outsides, self.outside_track)
            insides = self._maybe_flip(insides, self.inside_track)
            centres = self._maybe_flip(centres, self.inside_track)

        # uniform arc-length resampling (not per-segment upsampling, see
        # resample_uniform) with fold removal and re-smoothing until the
        # geometry is clean
        outsides = self._regularise(outsides)
        insides = self._regularise(insides)
        centres = self._regularise(centres)

        centres, insides, outsides = remove_near_duplicates(
            centres, insides, outsides
        )
        return {
            "outside_track": outsides,
            "inside_track": insides,
            "centre_track": centres,
        }

    def save_map(self, filename: str):
        outsides = self._flatten_nearest(self.outside_track)[
            TRIM_STATIONARY:-TRIM_STATIONARY
        ]
        insides = self._flatten_nearest(self.inside_track)[
            TRIM_STATIONARY:-TRIM_STATIONARY
        ]
        self._save_raw_points(filename, insides, outsides)
        output_map = self.build_map(insides, outsides)
        np.save(filename, output_map, allow_pickle=True)
        self.map_built = True
        return output_map

    @staticmethod
    def _save_raw_points(filename: str, insides, outsides):
        stem, ext = filename.rsplit(".", 1)
        np.save(
            f"{stem}-raw-points.{ext}",
            {"outsides": np.copy(outsides), "insides": np.copy(insides)},
            allow_pickle=True,
        )
