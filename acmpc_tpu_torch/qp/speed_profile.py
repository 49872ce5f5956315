"""Exact speed-profile solve.

Counterpart of the exact path of ``acmpc_tpu/qp/speed_profile.py``
(``velocity_upper_bounds``, ``_min_plus_scan``, ``solve_speed_profile``).
The speed QP

    minimize    1/2 ||v||^2 - v_hi' v
    subject to  a_min <= (v_{i+1} - v_i) / (2 ds_i) <= a_max
                v_lo  <= v <= v_hi

projects v_hi onto a lattice, so its solution is the pointwise minimum of
v_hi and two (min,+) prefix recurrences, computed here exactly. The
iterative ADMM cross-check and the sharded variants are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acmpc_tpu_torch.qp.admm import STATUS_MAX_ITER, STATUS_SOLVED

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class SpeedProfileConstraints:
    """Static speed-profile constraint set (configs/<track>.yaml
    ``*.control.speed_profile_constraints``)."""

    v_min: float
    v_max: float
    a_min: float
    a_max: float
    ay_max: float
    ki_min: float
    end_velocity: float | None = None

    @classmethod
    def from_config(cls, cfg: dict) -> "SpeedProfileConstraints":
        return cls(
            v_min=cfg["v_min"],
            v_max=cfg["v_max"],
            a_min=cfg["a_min"],
            a_max=cfg["a_max"],
            ay_max=cfg["ay_max"],
            ki_min=cfg["ki_min"],
            end_velocity=cfg.get("end_velocity"),
        )


@dataclasses.dataclass(frozen=True)
class SpeedProfileSolution:
    velocities: torch.Tensor  # (..., N)
    status: torch.Tensor  # (...,) int32
    iterations: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor


def _per_scenario(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or batch-shaped ``(...)`` value as a tensor that
    broadcasts against ``like`` of shape ``(..., N)``."""
    t = torch.as_tensor(value, device=like.device)
    if t.dtype.is_floating_point:
        t = t.to(like.dtype)
    return t[..., None] if t.dim() > 0 else t


def velocity_upper_bounds(
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    v_max_runtime,
    end_velocity: float | None,
) -> torch.Tensor:
    """Curvature-capped per-waypoint velocity ceiling. ``v_max_runtime``
    is the live reference speed, a scalar or one per scenario."""
    v_max_runtime = _per_scenario(v_max_runtime, kappas)
    abs_k = torch.abs(kappas)
    v_max_dyn = torch.sqrt(constraints.ay_max / (abs_k + _EPS))
    v_max_dyn = torch.where(abs_k < constraints.ki_min, v_max_runtime, v_max_dyn)
    v_caps = torch.minimum(v_max_dyn, v_max_runtime)
    v_caps = torch.clamp(v_caps, min=constraints.v_min) + 2.0
    if end_velocity is not None:
        v_caps = torch.cat(
            [v_caps[..., :-1], torch.full_like(v_caps[..., -1:], end_velocity)],
            dim=-1,
        )
    return v_caps


def _min_plus_scan(caps: torch.Tensor, slacks: torch.Tensor) -> torch.Tensor:
    """Exact solution of x_i = min(caps_i, x_{i-1} + slacks_{i-1}) over the
    last axis.

    Each step is the map h_i(x) = min(M_i, x + S_i); the maps compose as
    (M2,S2)o(M1,S1) = (min(M2, M1+S2), S1+S2), so the prefix composition
    is an inclusive scan. Written as a log-step doubling (Hillis-Steele):
    after the step of width d, element i holds the composition of the
    maps i-2d+1..i. ceil(log2 N) steps of elementwise work.
    """
    inf = torch.full_like(slacks[..., :1], math.inf)
    M = caps
    S = torch.cat([inf, slacks], dim=-1)
    n = caps.shape[-1]
    d = 1
    while d < n:
        m_prev, s_prev = M[..., :-d], S[..., :-d]
        m_cur, s_cur = M[..., d:], S[..., d:]
        M = torch.cat(
            [M[..., :d], torch.minimum(m_cur, m_prev + s_cur)], dim=-1
        )
        S = torch.cat([S[..., :d], s_prev + s_cur], dim=-1)
        d *= 2
    return M


def solve_speed_profile(
    distances: torch.Tensor,
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    v_max_runtime=None,
    localised=False,
    use_end_velocity: bool = True,
) -> SpeedProfileSolution:
    """Exact speed-profile solve: v* = min(v_hi, forward a_max-limited
    pass, backward a_min pass), each pass one (min,+) scan.

    ``distances``/``kappas`` are (..., N). ``v_max_runtime`` and
    ``localised`` are scalars or one per scenario; a localised scenario
    takes the flat cap (map speeds already encode curvature).
    """
    n = kappas.shape[-1]
    if v_max_runtime is None:
        v_max_runtime = constraints.v_max

    end_vel = constraints.end_velocity if use_end_velocity else None
    v_hi_std = velocity_upper_bounds(kappas, constraints, v_max_runtime, end_vel)
    v_hi_loc = torch.ones_like(kappas) * _per_scenario(v_max_runtime, kappas)
    v_hi = torch.where(_per_scenario(localised, kappas), v_hi_loc, v_hi_std)

    d = distances[..., : n - 1]
    fwd_slack = 2.0 * d * constraints.a_max
    bwd_slack = -2.0 * d * constraints.a_min

    forward = _min_plus_scan(v_hi, fwd_slack)
    backward = torch.flip(
        _min_plus_scan(torch.flip(v_hi, [-1]), torch.flip(bwd_slack, [-1])),
        [-1],
    )
    v = torch.minimum(forward, backward)

    # infeasible only if the accel band cannot bridge the caps above v_lo
    feasible = torch.all(v >= constraints.v_min - 1e-4, dim=-1)
    status = torch.where(feasible, STATUS_SOLVED, STATUS_MAX_ITER).to(torch.int32)
    zero = torch.zeros_like(v[..., 0])
    return SpeedProfileSolution(
        velocities=v,
        status=status,
        iterations=torch.zeros_like(status),
        r_prim=zero,
        r_dual=zero,
    )
