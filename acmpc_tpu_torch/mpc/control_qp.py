"""Horizon control-QP assembly.

Counterpart of ``acmpc_tpu/mpc/control_qp.py``: the dense QP of one MPC
step, batched over the path's leading dimensions.

variables  [x_0..x_n | u_0..u_{n-1}],  x in R^3 (e_y, e_psi, t), u in R^2
equalities -x_0 = -x_init ; A_k x_k - x_{k+1} + B_k u_k = B_k u_ref_k - f_k
box        identity over all variables: track-limit bounds on e_y (widths
           minus vehicle margin), t >= 0.01 (reference mode only), input
           box with +/-0.1 velocity slack; x_0's e_y pinned to the offset
cost       P = diag(step_cost*n, final_cost, r_term*n); inputs track
           (v_ref, kappa_ref)
"""

from __future__ import annotations

import torch

from acmpc_tpu_torch.device import constant
from acmpc_tpu_torch.dynamics.spatial_bicycle import SpatialBicycleModel, linearise
from acmpc_tpu_torch.geometry.path import ReferencePath
from acmpc_tpu_torch.qp.admm import ADMMConfig, QPSolution, _solve_box_qp

_INF = 1e30
NX = 3
NU = 2


def _tile_last(v: torch.Tensor, reps: int) -> torch.Tensor:
    """Repeat the last dimension ``reps`` times (``jnp.tile`` on it)."""
    return v.unsqueeze(-2).expand(*v.shape[:-1], reps, v.shape[-1]).reshape(
        *v.shape[:-1], reps * v.shape[-1]
    )


def assemble_control_qp(
    path: ReferencePath,
    spatial_state: torch.Tensor,
    model: SpatialBicycleModel,
    step_cost,
    r_term,
    final_cost,
    u_min=None,
    u_max=None,
    time_mode: str = "tuned",
):
    """Return (P, q, A, l, u) for the horizon QP of ``path`` (n waypoints,
    leading batch dims ``...``); ``spatial_state`` is (..., 3).

    time_mode:
      "tuned" (default) — reference time-row units with the contradictory
        t_0 >= 0.01 bound dropped (the production QP);
      "reference" — the reference QP verbatim, time row and bounds;
      "exact" — physical-seconds time row.
    """
    n = path.n_points
    lead = path.xs.shape[:-1]
    dtype, device = path.xs.dtype, path.xs.device
    n_var = NX * (n + 1) + NU * n
    n_eq = NX * (n + 1)

    def vec(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dtype, device=device)
        return constant(v, dtype, device)

    f, A_blocks, B_blocks = linearise(
        path, time_mode="exact" if time_mode == "exact" else "reference"
    )
    u_ref = torch.stack([path.velocities, path.kappas], dim=-1)  # (..., n, 2)

    # --- equality rows: [A_x | B_u] ------------------------------------
    A_eq = torch.zeros(*lead, n_eq, n_var, dtype=dtype, device=device)
    torch.diagonal(A_eq, dim1=-2, dim2=-1).fill_(-1.0)
    k = torch.arange(n, device=device)
    rows = (NX * (k + 1))[:, None, None] + torch.arange(NX, device=device)[None, :, None]
    cols_a = (NX * k)[:, None, None] + torch.arange(NX, device=device)[None, None, :]
    cols_b = (NX * (n + 1) + NU * k)[:, None, None] + torch.arange(
        NU, device=device
    )[None, None, :]
    # the A and B blocks sit off the diagonal, so setting equals adding
    A_eq[..., rows, cols_a] = A_blocks.to(dtype)
    A_eq[..., rows, cols_b] = B_blocks.to(dtype)

    # uq_k = B_k u_ref_k - f_k
    uq = (B_blocks @ u_ref[..., None])[..., 0] - f
    uq = uq.reshape(*lead, NX * n).to(dtype)
    eq_bound = torch.cat([-spatial_state.to(dtype).expand(*lead, NX), uq], dim=-1)

    # --- box rows (identity) -------------------------------------------
    # t >= 0.01 also binds t_0, which the initial-state equality pins to 0;
    # kept only in the verbatim reference mode
    t_min = 0.01 if time_mode == "reference" else -_INF
    x_min = _tile_last(vec([-_INF, -_INF, t_min]), n + 1).expand(*lead, n_eq).clone()
    x_max = _tile_last(vec([_INF, _INF, _INF]), n + 1).expand(*lead, n_eq).clone()
    ey0 = spatial_state[..., 0].to(dtype).expand(lead)
    x_min[..., 0] = ey0
    x_max[..., 0] = ey0
    half_drivable = path.widths / 2.0 - model.margin
    ey_idx = NX * (k + 1)
    x_min[..., ey_idx] = -half_drivable
    x_max[..., ey_idx] = half_drivable

    # input box, overridable per call; velocity slack of +/-0.1
    slack = _tile_last(vec([0.1, 0.0]), n)
    u_lo = _tile_last(vec(model.min_u if u_min is None else u_min), n) - slack
    u_hi = _tile_last(vec(model.max_u if u_max is None else u_max), n) + slack

    l = torch.cat([eq_bound, x_min, u_lo.expand(*lead, NU * n)], dim=-1)
    u_bnd = torch.cat([eq_bound, x_max, u_hi.expand(*lead, NU * n)], dim=-1)

    # the box block: the solver's callers here pass box=True, and its
    # chunks take it as a diagonal (qp/admm._solve_box_qp)
    A_box = torch.eye(n_var, dtype=dtype, device=device).expand(*lead, n_var, n_var)
    A = torch.cat([A_eq, A_box], dim=-2)

    # --- cost -----------------------------------------------------------
    step_cost, r_term, final_cost = vec(step_cost), vec(r_term), vec(final_cost)
    cost_lead = torch.broadcast_shapes(
        step_cost.shape[:-1], r_term.shape[:-1], final_cost.shape[:-1]
    )
    P_diag = torch.cat(
        [
            _tile_last(step_cost, n).expand(*cost_lead, NX * n),
            final_cost.expand(*cost_lead, NX),
            _tile_last(r_term, n).expand(*cost_lead, NU * n),
        ],
        dim=-1,
    )
    P = torch.diag_embed(P_diag.expand(*lead, n_var))
    # state reference is the corridor centre (0), so the state part of q
    # vanishes; inputs track (v_ref, kappa_ref)
    urs = u_ref.reshape(*lead, NU * n).to(dtype)
    q = torch.cat(
        [
            torch.zeros(*lead, n_eq, dtype=dtype, device=device),
            -_tile_last(r_term, n) * urs,
        ],
        dim=-1,
    )
    return P, q, A, l, u_bnd


def control_qp_sizes(horizon: int) -> tuple[int, int]:
    """(n_var, n_constraints) for a given MPC horizon."""
    n = horizon - 1
    n_var = NX * (n + 1) + NU * n
    return n_var, NX * (n + 1) + n_var


def solve_control_qp(
    path: ReferencePath,
    spatial_state: torch.Tensor,
    model: SpatialBicycleModel,
    step_cost,
    r_term,
    final_cost,
    cfg: ADMMConfig = ADMMConfig(),
    x0: torch.Tensor | None = None,
    y0: torch.Tensor | None = None,
) -> QPSolution:
    """Assemble and solve. ``x0``/``y0`` warm-start the ADMM iterates, as
    OSQP keeps its iterates across ``problem.update()`` calls. With one
    leading scenario axis on ``path`` and ``spatial_state``, each lane is
    solved as it would be alone (``solve_box_qp`` over the axis)."""
    P, q, A, l, u = assemble_control_qp(
        path, spatial_state, model, step_cost, r_term, final_cost
    )
    return _solve_box_qp(P, q, A, l, u, cfg, x0=x0, y0=y0, box=True)
