"""Kinematic spatial bicycle model.

Counterpart of ``acmpc_tpu/dynamics/spatial_bicycle.py``. State is the
spatial error frame (e_y, e_psi, t) along a reference path, inputs are
(v, kappa) with kappa = tan(delta)/L. ``t2s``, ``s2t`` and ``linearise``
work over whole paths with any leading batch dimensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.geometry.path import ReferencePath, wrap_to_pi

_EPS = 1e-12


def t2s(reference_waypoint: torch.Tensor, reference_state: torch.Tensor) -> torch.Tensor:
    """Temporal state [x, y, psi] -> spatial state [e_y, e_psi, t] relative
    to a reference waypoint [x_r, y_r, psi_r]; shapes ``(..., 3)``."""
    ref_x, ref_y, ref_psi = reference_waypoint.unbind(-1)
    x, y, psi = reference_state.unbind(-1)
    e_y = torch.cos(ref_psi) * (y - ref_y) - torch.sin(ref_psi) * (x - ref_x)
    e_psi = wrap_to_pi(psi - ref_psi)
    t = torch.zeros_like(e_y)
    return torch.stack([e_y, e_psi, t], dim=-1)


def s2t(path: ReferencePath, spatial_states: torch.Tensor) -> torch.Tensor:
    """Spatial states (..., N, 3) -> temporal [xs, ys, psis] stacked as
    (..., 3, N) along the waypoints of ``path``."""
    xs = path.xs - spatial_states[..., 0] * torch.sin(path.psis)
    ys = path.ys + spatial_states[..., 0] * torch.cos(path.psis)
    psis = path.psis + spatial_states[..., 1]
    return torch.stack([xs, ys, psis], dim=-2)


def linearise(path: ReferencePath, time_mode: str = "reference"):
    """Jacobian linearisation of the spatial dynamics around the reference
    velocities/curvatures of ``path``.

    Returns ``(f, A, B)`` with shapes (..., N, 3), (..., N, 3, 3),
    (..., N, 3, 2):
      A_k = [[1,         ds_k, 0],
             [-k_k^2 ds, 1,    0],
             [dt_dey_k,  0,    1]]
      B_k = [[0, 0], [0, ds_k], [dt_dv_k, 0]]
      f_k = [0, 0, dt_nom_k]

    ``time_mode="exact"`` linearises the physical stage time
    dt = ds (1 - kappa e_y) / v; ``"reference"`` (default) divides by
    (v ds) instead, the units the shipped configs' time weights were
    tuned against (see the JAX counterpart's docstring).
    """
    ds = path.distances
    kappa = path.kappas
    v = path.velocities
    zeros = torch.zeros_like(ds)
    ones = torch.ones_like(ds)

    if time_mode == "reference":
        dt_dey = -kappa / (v * ds + _EPS)
        dt_dv = -1.0 / (v**2 * ds + _EPS)
        dt_nom = 1.0 / (v * ds + _EPS)
    else:
        dt_dey = -kappa * ds / (v + _EPS)
        dt_dv = -ds / (v**2 + _EPS)
        dt_nom = ds / (v + _EPS)

    a_1 = torch.stack([ones, ds, zeros], dim=-1)
    a_2 = torch.stack([-(kappa**2) * ds, ones, zeros], dim=-1)
    a_3 = torch.stack([dt_dey, zeros, ones], dim=-1)
    A = torch.stack([a_1, a_2, a_3], dim=-2)

    b_1 = torch.stack([zeros, zeros], dim=-1)
    b_2 = torch.stack([zeros, ds], dim=-1)
    b_3 = torch.stack([dt_dv, zeros], dim=-1)
    B = torch.stack([b_1, b_2, b_3], dim=-2)

    f = torch.stack([zeros, zeros, dt_nom], dim=-1)
    return f, A, B


@dataclasses.dataclass(frozen=True)
class SpatialBicycleModel:
    """Vehicle geometry with velocity limits; exposes the input box of the
    control QP."""

    vehicle: VehicleParams
    min_velocity: float
    max_velocity: float

    @property
    def length(self) -> float:
        return self.vehicle.wheelbase

    @property
    def width(self) -> float:
        return self.vehicle.width

    @property
    def delta_max(self) -> float:
        return self.vehicle.max_steering_angle

    @property
    def margin(self) -> float:
        return self.vehicle.margin

    @property
    def kappa_max(self) -> float:
        return float(np.tan(self.delta_max) / self.length)

    @property
    def min_u(self) -> np.ndarray:
        return np.array([self.min_velocity, -self.kappa_max])

    @property
    def max_u(self) -> np.ndarray:
        return np.array([self.max_velocity, self.kappa_max])
