"""Reference-path representation and waypoint construction.

Counterpart of ``acmpc_tpu/geometry/path.py``. The path is a small
dataclass of tensors, each of shape ``(..., N)``: leading dimensions are
scenario batch dimensions, written out where the JAX package used
``vmap``. Every function here follows the device of its inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ReferencePath:
    """Struct-of-tensors waypoint path. All fields share shape ``(..., N)``.

    xs, ys          world/BEV coordinates of each waypoint
    psis            heading of the segment leaving each waypoint
    kappas          discrete curvature at each waypoint
    distances       arc length of the segment leaving each waypoint
    widths          drivable width at each waypoint
    velocities      reference speed profile (filled by the speed profile)
    """

    xs: torch.Tensor
    ys: torch.Tensor
    psis: torch.Tensor
    kappas: torch.Tensor
    distances: torch.Tensor
    widths: torch.Tensor
    velocities: torch.Tensor

    @property
    def n_points(self) -> int:
        return self.xs.shape[-1]

    def state(self, index: int) -> torch.Tensor:
        """``[x, y, psi]`` at a waypoint, shape ``(..., 3)``."""
        return torch.stack(
            [self.xs[..., index], self.ys[..., index], self.psis[..., index]],
            dim=-1,
        )


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles into [-pi, pi) (floor-mod, as ``jnp.mod``)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def construct_waypoints(waypoint_coordinates: torch.Tensor) -> ReferencePath:
    """Turn a ``(..., N+1, 3)`` tensor of ``[x, y, width]`` into a
    ReferencePath of N waypoints.

    psi_i   = atan2(p_{i+1} - p_i)
    ds_i    = |p_{i+1} - p_i|
    kappa_i = wrap(psi_i - psi_{i-1}) / (ds_i + eps) + eps, with the
              "behind" angle of point 0 taken from the wrapped-around last
              point, and kappa_0 overwritten with kappa_1.
    widths come from rows 1..N (the *next* point's width column).
    """
    coords = waypoint_coordinates
    current = coords[..., :-1, :2]
    nxt = coords[..., 1:, :2]
    previous = torch.cat([coords[..., -1:, :2], coords[..., :-2, :2]], dim=-2)

    diffs_ahead = nxt - current
    diffs_behind = current - previous

    psis = torch.atan2(diffs_ahead[..., 1], diffs_ahead[..., 0])
    distances = torch.linalg.vector_norm(diffs_ahead, dim=-1)

    angles_behind = torch.atan2(diffs_behind[..., 1], diffs_behind[..., 0])
    angle_diffs = wrap_to_pi(psis - angles_behind)
    kappas = angle_diffs / (distances + _EPS) + _EPS
    kappas = torch.cat([kappas[..., 1:2], kappas[..., 1:]], dim=-1)

    return ReferencePath(
        xs=coords[..., :-1, 0],
        ys=coords[..., :-1, 1],
        psis=psis,
        kappas=kappas,
        distances=distances,
        widths=coords[..., 1:, 2],
        velocities=torch.zeros_like(psis),
    )
