"""Track map container, IO and brute-force nearest neighbour.

Counterpart of ``acmpc_tpu/localise/track_map.py``. The native format is
a plain ``.npz`` with ``centre``, ``left`` and ``right`` arrays; a
``.json`` with ``Centre``, ``Outside`` and ``Inside`` keys and the pickled
``.npy`` dict of the original stack (outside -> left, inside -> right)
are also read, with numpy alone. Every polyline loses its consecutive
near-duplicate points on load.

On the device the map is a frozen dataclass of fp32 tensors.
Nearest-neighbour queries are brute-force distance argmins: a (K, M)
distance matrix is one matrix product plus elementwise work, which
beats a KD-tree for the 10^3-10^5-point maps this system uses.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device


def _remove_near_duplicates(points: np.ndarray, threshold: float = 1e-4) -> np.ndarray:
    """Drop consecutive near-duplicate points."""
    if len(points) < 2:
        return points
    keep = np.ones(len(points), dtype=bool)
    diffs = np.linalg.norm(np.diff(points, axis=0), axis=1)
    keep[1:] = diffs > threshold
    return points[keep]


@dataclasses.dataclass(frozen=True)
class TrackMap:
    """Three fixed-shape polylines, each (M, 2) fp32."""

    centre: torch.Tensor  # (Mc, 2)
    left: torch.Tensor  # (Ml, 2)
    right: torch.Tensor  # (Mr, 2)

    @property
    def n_centre(self) -> int:
        return self.centre.shape[0]

    @property
    def average_spacing(self) -> torch.Tensor:
        d = torch.linalg.vector_norm(self.centre[1:] - self.centre[:-1], dim=1)
        return torch.mean(d)


def nearest_point(points: torch.Tensor, polyline: torch.Tensor, refine: int = 32):
    """Brute-force nearest neighbour: points (..., K, 2) against polyline
    (M, 2). Returns (distances (..., K), indices (..., K)).

    Coarse: the argmin over the map of |m|^2 - 2 p.m, which is d^2 less
    |p|^2, the same for every map point of a row; one (K, M) matrix
    product (of p with -2 m, exact in fp32) and one add, in place. It
    must be full fp32 (TF32 is off, package ``__init__``): at km-scale
    coordinates the terms reach ~1e6 and the cancellation leaves metres
    of signal, which a 10-bit mantissa turns into tens of metres of index
    error. Refine: exact squared differences over a +-``refine`` index
    window around the coarse argmin, free of cancellation, so the index
    is the true nearest neighbour whenever the coarse pick lands within
    ``refine`` points of it.
    """
    m = polyline.shape[0]
    m2 = torch.sum(polyline**2, dim=-1)  # (M,)
    d2 = torch.matmul(points, -2.0 * polyline.T)  # (..., K, M)
    d2 += m2
    coarse = torch.min(d2, dim=-1).indices  # (..., K), the first minimum
    offs = torch.arange(-refine, refine + 1, device=points.device)
    cand_idx = torch.remainder(coarse[..., None] + offs, m)  # (..., K, 2R+1)
    cand = polyline[cand_idx]  # (..., K, 2R+1, 2)
    d2r = torch.sum((points[..., None, :] - cand) ** 2, dim=-1)
    j = torch.argmin(d2r, dim=-1, keepdim=True)
    idx = torch.gather(cand_idx, -1, j)[..., 0]
    dist = torch.sqrt(torch.gather(d2r, -1, j)[..., 0])
    return dist, idx


def _read_polylines(path: pathlib.Path) -> dict[str, np.ndarray]:
    if path.suffix == ".npz":
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in ("centre", "left", "right")}
    if path.suffix == ".json":
        d = json.loads(path.read_text())
        return {
            "left": np.asarray(d["Outside"]),
            "right": np.asarray(d["Inside"]),
            "centre": np.asarray(d["Centre"]),
        }
    # the original stack's pickled dict: a map file this repository ships
    # or writes, never one from outside
    d = np.load(path, allow_pickle=True).item()

    def pick(*keys):
        for k in keys:
            if k in d:
                return np.asarray(d[k])
        raise KeyError(f"none of {keys} in map file {path}")

    return {
        "left": pick("left", "outside_track", "outside"),
        "right": pick("right", "inside_track", "inside"),
        "centre": pick("centre", "centre_track"),
    }


def load_track_map(
    path: str | pathlib.Path, device: torch.device | str | None = None
) -> TrackMap:
    """Load a map from ``.npz``, ``.json`` or the pickled ``.npy`` dict
    onto ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    raw = _read_polylines(pathlib.Path(path))
    clean = {
        k: _remove_near_duplicates(v[:, :2].astype(np.float32)) for k, v in raw.items()
    }
    return TrackMap(**{k: torch.tensor(v, device=device) for k, v in clean.items()})


def save_track_map(path: str | pathlib.Path, centre, left, right):
    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    np.savez(path, centre=host(centre), left=host(left), right=host(right))
