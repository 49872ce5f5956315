"""Plain reference of the closed-loop lap step around the controller:
the ego window a car takes from the map, the command it selects from
the solved plan, and the kinematic bicycle that integrates it.

The same semantics as a closed-loop lap sweep: the window is every
``stride``-th centreline point from the nearest one, turned into the
car's frame (x right, y forward) with the corridor width beside it;
after the solve the car takes the command of the plan's clock nearest
``dt`` (the one before it where that lies ahead), the speed follows it
within three times the configured acceleration band, and the car moves
by ``dt``. Any leading batch dims; the dtype of the inputs.

The ``control_b1`` traffic runs its car with these same functions: for
that cell they generate the inputs, for the sweep they judge its cars.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def load_centre(path: str) -> np.ndarray:
    """The map's centreline (M, 2) as stored, without consecutive
    near-duplicate points."""
    pts = np.load(path)["centre"].astype(np.float64)
    keep = np.ones(len(pts), bool)
    keep[1:] = np.linalg.norm(np.diff(pts, axis=0), axis=1) > 1e-4
    return pts[keep]


def stride(centre: np.ndarray, spacing_m: float) -> int:
    mean = float(np.linalg.norm(np.diff(centre, axis=0), axis=1).mean())
    return max(1, int(round(spacing_m / mean)))


def sq_dist(centre: torch.Tensor, x, y) -> torch.Tensor:
    dx = centre[:, 0] - x[..., None]
    dy = centre[:, 1] - y[..., None]
    return dx * dx + dy * dy


def nearest(centre: torch.Tensor, x, y) -> torch.Tensor:
    return torch.argmin(sq_dist(centre, x, y), dim=-1)


def window(centre: torch.Tensor, x, y, yaw, i0, step: int, horizon: int, width: float):
    """(..., H, 3) of [x, y, width] in the car's frame, from point i0."""
    m = centre.shape[0]
    idx = torch.remainder(i0[..., None] + step * torch.arange(horizon, device=centre.device), m)
    world = centre[idx]
    dx, dy = world[..., 0] - x[..., None], world[..., 1] - y[..., None]
    a = (-yaw + math.pi / 2)[..., None]
    bx = dx * torch.cos(a) - dy * torch.sin(a)
    by = dx * torch.sin(a) + dy * torch.cos(a)
    return torch.stack([bx, by, torch.full_like(bx, width)], dim=-1)


def shift_stages(i0, prev_i0, m: int, step: int, horizon: int):
    """Reference stages the window moved since the last solve (a
    backward slip counts as none)."""
    delta = torch.remainder(i0 - prev_i0, m)
    delta = torch.where(delta > m // 2, 0, delta)
    k = torch.round(delta / step).to(torch.int32)
    return torch.clamp(k, 0, horizon - 1)


def select(cum_time, projected, elapsed: float):
    """(speed, steering) of the plan at ``elapsed`` seconds."""
    dist = cum_time - elapsed
    i = torch.argmin(torch.abs(dist), dim=-1, keepdim=True)
    i = torch.where(torch.gather(dist, -1, i) > 0, i - 1, i)
    i = torch.clamp(i, 0, cum_time.shape[-1] - 1)
    v = torch.gather(projected[..., 0, :], -1, i)[..., 0]
    d = torch.gather(projected[..., 1, :], -1, i)[..., 0]
    return v, d


def integrate(car: dict, v_cmd, delta, dt: float, a_min: float, a_max: float, wheelbase: float) -> dict:
    dv = torch.clamp(v_cmd - car["v"], a_min * 3 * dt, a_max * 3 * dt)
    v = torch.clamp(car["v"] + dv, min=0.0)
    yaw = torch.remainder(car["yaw"] + v * torch.tan(delta) / wheelbase * dt + math.pi, 2 * math.pi) - math.pi
    return {
        "x": car["x"] + v * torch.cos(car["yaw"]) * dt,
        "y": car["y"] + v * torch.sin(car["yaw"]) * dt,
        "yaw": yaw,
        "v": v,
    }


def start(centre: torch.Tensor, index, offset, v0: float = 10.0) -> dict:
    """Cars on the centreline at ``index``, heading along it, moved
    ``offset`` metres to the left."""
    m = centre.shape[0]
    p0 = centre[torch.remainder(index, m)]
    p1 = centre[torch.remainder(index + 1, m)]
    yaw = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    normal = torch.stack([-torch.sin(yaw), torch.cos(yaw)], dim=-1)
    pos = p0 + offset[..., None] * normal
    return {"x": pos[..., 0], "y": pos[..., 1], "yaw": yaw, "v": torch.full_like(yaw, v0)}
