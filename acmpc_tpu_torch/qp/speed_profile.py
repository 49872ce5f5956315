"""Exact speed-profile solve.

Counterpart of the exact path of ``acmpc_tpu/qp/speed_profile.py``
(``velocity_upper_bounds``, ``_min_plus_scan``, ``solve_speed_profile``).
The speed QP

    minimize    1/2 ||v||^2 - v_hi' v
    subject to  a_min <= (v_{i+1} - v_i) / (2 ds_i) <= a_max
                v_lo  <= v <= v_hi

projects v_hi onto a lattice, so its solution is the pointwise minimum of
v_hi and two (min,+) prefix recurrences, computed here exactly.

Beside it, as in the JAX package: the iterative ADMM solve of the same QP
(``solve_speed_profile_admm``, an independent cross-check whose x-update
is a tridiagonal PCR solve), and both solves with the horizon sharded
over a mesh axis (``solve_speed_profile_sharded``,
``solve_speed_profile_admm_sharded``): each rank holds a contiguous slab
of waypoints and the blocks combine through a few scalars a rank.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acmpc_tpu_torch.device import scalar
from acmpc_tpu_torch.ops.tridiag import tridiag_solve
from acmpc_tpu_torch.ops.tridiag_sharded import tridiag_solve_sharded
from acmpc_tpu_torch.qp.admm import STATUS_MAX_ITER, STATUS_SOLVED, ADMMConfig

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
    t = scalar(value, like.device)
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


def _min_plus_prefix(M: torch.Tensor, S: torch.Tensor):
    """Inclusive prefix composition of the maps h_i(x) = min(M_i, x + S_i)
    over the last axis; returns the composed (M, S).

    The maps compose as (M2,S2)o(M1,S1) = (min(M2, M1+S2), S1+S2). Written
    as a log-step doubling (Hillis-Steele): after the step of width d,
    element i holds the composition of the maps i-2d+1..i.
    ceil(log2 N) steps of elementwise work.
    """
    n = M.shape[-1]
    d = 1
    while d < n:
        m_prev, s_prev = M[..., :-d], S[..., :-d]
        m_cur, s_cur = M[..., d:], S[..., d:]
        M = torch.cat(
            [M[..., :d], torch.minimum(m_cur, m_prev + s_cur)], dim=-1
        )
        S = torch.cat([S[..., :d], s_prev + s_cur], dim=-1)
        d *= 2
    return M, S


def _min_plus_scan(caps: torch.Tensor, slacks: torch.Tensor) -> torch.Tensor:
    """Exact solution of x_i = min(caps_i, x_{i-1} + slacks_{i-1}) over the
    last axis: the prefix composition of the maps (caps_i, slacks_{i-1}),
    the first with an infinite slack."""
    inf = torch.full_like(slacks[..., :1], math.inf)
    return _min_plus_prefix(caps, torch.cat([inf, slacks], dim=-1))[0]


def _min_plus_combine(left, right):
    m1, s1 = left
    m2, s2 = right
    return torch.minimum(m2, m1 + s2), s1 + s2


def _min_plus_scan_sharded(
    caps: torch.Tensor,
    slack_in: torch.Tensor,
    mesh,
    axis_name: str | None = None,
    reverse_blocks: bool = False,
) -> torch.Tensor:
    """Sharded (min,+) scan: a prefix scan of each rank's block, ONE
    all-gather of each block's total map (2 floats a rank), the exclusive
    composition over the blocks (on every rank alike) and an elementwise
    fix-up.

    ``caps``/``slack_in`` are the local block (..., M); ``slack_in[..., 0]``
    is the slack crossing from the predecessor block (+inf on the first).
    ``reverse_blocks`` takes the ranks right to left (the caller flips
    its block): the backward pass, with no data moved between ranks.

    Within a block the doubling groups each sum as the single-device scan
    does; a chain of two or more slacks that crosses a block edge is
    summed block by block instead, so it may round differently.
    """
    idx = mesh.axis_index(axis_name)
    m_local, s_local = _min_plus_prefix(caps, slack_in)
    block = torch.stack([m_local[..., -1], s_local[..., -1]], dim=-1)
    blocks = mesh.all_gather(block, axis_name)  # (S, ..., 2)
    n_blocks = blocks.shape[0]
    order = range(n_blocks - 1, -1, -1) if reverse_blocks else range(n_blocks)
    m_acc = torch.full_like(block[..., 0], math.inf)
    s_acc = torch.zeros_like(block[..., 0])
    for b in order:  # S is the number of ranks on the axis
        if b == idx:
            break
        m_acc, s_acc = _min_plus_combine((m_acc, s_acc), (blocks[b, ..., 0], blocks[b, ..., 1]))
    return torch.minimum(m_local, m_acc[..., None] + s_local)


def solve_speed_profile_sharded(
    distances: torch.Tensor,
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    mesh,
    axis_name: str | None = None,
    v_max_runtime=None,
    localised=False,
    use_end_velocity: bool = False,
) -> torch.Tensor:
    """Exact speed profile with the horizon sharded over ``axis_name`` of
    ``mesh``; returns this rank's slab of velocities.

    Each rank holds a contiguous slab of M waypoints; ``distances[..., j]``
    is the edge LEAVING local waypoint j (the last one crosses into the
    next slab). The only data a rank needs from another is its
    predecessor's last edge (one shift), and the scans combine through
    2-float block summaries. ``use_end_velocity`` defaults off: the pin
    lands on the last rank's last waypoint, which is a padded one
    whenever the caller padded the map to a multiple of the ranks.
    """
    if v_max_runtime is None:
        v_max_runtime = constraints.v_max
    idx = mesh.axis_index(axis_name)
    n_dev = mesh.axis_size(axis_name)
    end_vel = constraints.end_velocity if use_end_velocity else None

    v_hi_std = velocity_upper_bounds(kappas, constraints, v_max_runtime, None)
    if end_vel is not None and idx == n_dev - 1:
        v_hi_std = torch.cat(
            [v_hi_std[..., :-1], torch.full_like(v_hi_std[..., -1:], end_vel)], dim=-1
        )
    v_hi_loc = torch.ones_like(kappas) * _per_scenario(v_max_runtime, kappas)
    v_hi = torch.where(_per_scenario(localised, kappas), v_hi_loc, v_hi_std)

    # the predecessor's last edge (one shift right along the axis)
    prev_last_d = mesh.from_prev(distances[..., -1].contiguous(), axis=axis_name)
    inf = torch.full_like(distances[..., :1], math.inf)

    # forward pass: the slack entering local j is the edge leaving j-1
    fwd = 2.0 * distances * constraints.a_max
    fwd_cross = inf if idx == 0 else (2.0 * prev_last_d * constraints.a_max)[..., None]
    forward = _min_plus_scan_sharded(
        v_hi, torch.cat([fwd_cross, fwd[..., :-1]], dim=-1), mesh, axis_name
    )

    # backward pass: the forward scan on flipped blocks, ranks right to
    # left; a flipped block's crossing edge is its own last edge
    bwd = -2.0 * distances * constraints.a_min
    bwd_cross = inf if idx == n_dev - 1 else bwd[..., -1:]
    bwd_in = torch.cat([bwd_cross, torch.flip(bwd[..., :-1], [-1])], dim=-1)
    backward = torch.flip(
        _min_plus_scan_sharded(
            torch.flip(v_hi, [-1]), bwd_in, mesh, axis_name, reverse_blocks=True
        ),
        [-1],
    )
    return torch.minimum(forward, backward)


def solve_speed_profile(
    distances: torch.Tensor,
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    v_max_runtime=None,
    localised=False,
    use_end_velocity: bool = True,
    cfg: ADMMConfig = ADMMConfig(),
    v0: torch.Tensor | None = None,
) -> SpeedProfileSolution:
    """Exact speed-profile solve: v* = min(v_hi, forward a_max-limited
    pass, backward a_min pass), each pass one (min,+) scan.

    ``distances``/``kappas`` are (..., N). ``v_max_runtime`` and
    ``localised`` are scalars or one per scenario; a localised scenario
    takes the flat cap (map speeds already encode curvature). ``cfg``
    and ``v0`` are ignored: the scan is exact and iterates nothing. They
    are taken for the JAX package's signature, which keeps them for API
    compatibility (:func:`solve_speed_profile_admm` uses a ``cfg``).
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


def _bounds(kappas, constraints, v_max_runtime, localised, end_vel):
    """(v_hi, q = -v_hi) of one profile, ``v_max_runtime`` as a tensor."""
    v_hi_std = velocity_upper_bounds(kappas, constraints, v_max_runtime, end_vel)
    v_hi_loc = torch.ones_like(kappas) * v_max_runtime
    v_hi = torch.where(scalar(localised, kappas.device), v_hi_loc, v_hi_std)
    return v_hi, -v_hi


def _admm_loop(x, q, A_mul, AT_mul, K_parts, solve, bounds, residuals, cfg: ADMMConfig):
    """The relaxed ADMM iterations of the speed QP, ``cfg.check_every`` at
    a time, until the residuals meet the tolerances or ``cfg.max_iter``
    (one host read a check). Returns (x, status, iterations, r_prim,
    r_dual)."""
    (a_lo, a_hi), (v_lo, v_hi) = bounds
    dtype, device = x.dtype, x.device
    sigma, alpha = cfg.sigma, cfg.alpha
    za, zv = A_mul(x)
    za = torch.clamp(za, a_lo, a_hi)
    zv = torch.clamp(zv, v_lo, v_hi)
    ya, yv = torch.zeros_like(za), torch.zeros_like(zv)
    rho = torch.tensor(cfg.rho, dtype=dtype, device=device)
    r_p = r_d = torch.tensor(math.inf, dtype=dtype, device=device)
    it, done = 0, False
    while not done and it < cfg.max_iter:
        sub, diag, sup = K_parts(rho)
        for _ in range(cfg.check_every):
            rhs = sigma * x - q + AT_mul(rho * za - ya, rho * zv - yv)
            xt = solve(sub, diag, sup, rhs)
            zta, ztv = A_mul(xt)
            x = alpha * xt + (1.0 - alpha) * x
            zra = alpha * zta + (1.0 - alpha) * za
            zrv = alpha * ztv + (1.0 - alpha) * zv
            za_new = torch.clamp(zra + ya / rho, a_lo, a_hi)
            zv_new = torch.clamp(zrv + yv / rho, v_lo, v_hi)
            ya = ya + rho * (zra - za_new)
            yv = yv + rho * (zrv - zv_new)
            za, zv = za_new, zv_new
        it += cfg.check_every
        r_p, r_d, converged, ratio = residuals(x, za, zv, ya, yv)
        if cfg.adaptive_rho:
            tol = cfg.adaptive_rho_tol
            need = (ratio > tol) | (ratio < 1.0 / tol)
            rho = torch.where(need & ~converged, torch.clamp(rho * ratio, 1e-6, 1e6), rho)
        done = bool(converged)
    status = torch.tensor(STATUS_SOLVED if done else STATUS_MAX_ITER, dtype=torch.int32, device=device)
    return x, status, torch.tensor(it, dtype=torch.int32, device=device), r_p, r_d


def _residual_test(maxima: torch.Tensor, cfg: ADMMConfig):
    """The convergence test and the rho-balancing ratio from the ten
    maxima |Ax_a - z_a|, |Ax_v - z_v|, |x + q + A'y|, |Ax_a|, |Ax_v|,
    |z_a|, |z_v|, |x|, |A'y|, |q|."""
    r_prim = torch.maximum(maxima[0], maxima[1])
    r_dual = maxima[2]
    ax_n = torch.maximum(maxima[3], maxima[4])
    z_n = torch.maximum(maxima[5], maxima[6])
    eps_prim = cfg.eps_abs + cfg.eps_rel * torch.maximum(ax_n, z_n)
    d_n = torch.maximum(torch.maximum(maxima[7], maxima[8]), maxima[9])
    eps_dual = cfg.eps_abs + cfg.eps_rel * d_n
    converged = (r_prim <= eps_prim) & (r_dual <= eps_dual)
    prim_n = r_prim / torch.clamp(torch.maximum(ax_n, z_n), min=1e-10)
    dual_n = r_dual / torch.clamp(d_n, min=1e-10)
    ratio = torch.sqrt(prim_n / torch.clamp(dual_n, min=1e-10))
    return r_prim, r_dual, converged, ratio


def _maxima(x, q, za, zv, ya, yv, A_mul, AT_mul) -> torch.Tensor:
    """The local maxima of :func:`_residual_test`, stacked."""
    axa, axv = A_mul(x)
    aty = AT_mul(ya, yv)
    return torch.stack([
        torch.max(torch.abs(v))
        for v in (axa - za, axv - zv, x + q + aty, axa, axv, za, zv, x, aty, q)
    ])


def solve_speed_profile_admm(
    distances: torch.Tensor,
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    v_max_runtime=None,
    localised=False,
    use_end_velocity: bool = True,
    cfg: ADMMConfig = ADMMConfig(),
    v0: torch.Tensor | None = None,
) -> SpeedProfileSolution:
    """Iterative ADMM solve of the same QP, one profile (N,): an
    independent cross-check of the exact scan, and the general engine if
    the cost ever stops being a projection. The x-update matrix
    P + sigma I + rho (D1'D1 + I) is tridiagonal and diagonally dominant,
    so each iteration is one PCR solve (``ops/tridiag.py``)."""
    dtype, device = distances.dtype, distances.device
    n = kappas.shape[-1]
    if v_max_runtime is None:
        v_max_runtime = constraints.v_max
    v_max_runtime = torch.as_tensor(v_max_runtime, dtype=dtype, device=device)
    end_vel = constraints.end_velocity if use_end_velocity else None
    v_hi, q = _bounds(kappas, constraints, v_max_runtime, localised, end_vel)
    v_lo = torch.full((n,), constraints.v_min, dtype=dtype, device=device)
    a_lo = torch.full((n - 1,), constraints.a_min, dtype=dtype, device=device)
    a_hi = torch.full((n - 1,), constraints.a_max, dtype=dtype, device=device)
    inv2d = 1.0 / (2.0 * distances[..., : n - 1])
    zero = torch.zeros_like(inv2d[..., :1])
    sigma = torch.tensor(cfg.sigma, dtype=dtype, device=device)

    def A_mul(v):
        return (v[..., 1:] - v[..., :-1]) * inv2d, v

    def AT_mul(w_acc, w_vel):
        g = torch.cat([-w_acc * inv2d, zero], dim=-1)
        g = g + torch.cat([zero, w_acc * inv2d], dim=-1)
        return g + w_vel

    def K_parts(rho):
        """Tridiagonal P + sigma I + rho (D1'D1 + I)."""
        w = inv2d**2
        diag = 1.0 + sigma + rho
        diag = diag + rho * torch.cat([w, zero], dim=-1)
        diag = diag + rho * torch.cat([zero, w], dim=-1)
        off = -rho * w  # entries (j, j+1), j = 0..n-2
        return torch.cat([zero, off], dim=-1), diag, torch.cat([off, zero], dim=-1)

    def residuals(x, za, zv, ya, yv):
        return _residual_test(_maxima(x, q, za, zv, ya, yv, A_mul, AT_mul), cfg)

    x = torch.zeros((n,), dtype=dtype, device=device) if v0 is None else torch.as_tensor(v0, dtype=dtype, device=device)
    x, status, it, r_p, r_d = _admm_loop(
        x, q, A_mul, AT_mul, K_parts, tridiag_solve,
        ((a_lo, a_hi), (v_lo, v_hi)), residuals, cfg,
    )
    return SpeedProfileSolution(velocities=x, status=status, iterations=it, r_prim=r_p, r_dual=r_d)


def solve_speed_profile_admm_sharded(
    distances: torch.Tensor,
    kappas: torch.Tensor,
    constraints: SpeedProfileConstraints,
    mesh,
    axis_name: str | None = None,
    v_max_runtime=None,
    localised=False,
    use_end_velocity: bool = True,
    cfg: ADMMConfig = ADMMConfig(),
    v0: torch.Tensor | None = None,
) -> SpeedProfileSolution:
    """The ADMM solve with the horizon sharded over ``axis_name`` of
    ``mesh``: the x-update solves the global tridiagonal system by SPIKE
    (``ops/tridiag_sharded.py``: local PCR, one 6-float all-gather, the
    interface solve on every rank); the acceleration rows couple
    neighbouring slabs, so the constraint products exchange one element
    a side (``from_next`` in A, ``from_prev`` in A'); the residual maxima
    combine in one ``pmax``, so every rank takes the same convergence
    decision and the loops stay in lockstep.

    Local layout as :func:`solve_speed_profile_sharded`. Returns this
    rank's slab of velocities with the status, iterations and residuals
    every rank shares.
    """
    dtype, device = distances.dtype, distances.device
    m = kappas.shape[-1]
    if v_max_runtime is None:
        v_max_runtime = constraints.v_max
    v_max_runtime = torch.as_tensor(v_max_runtime, dtype=dtype, device=device)
    idx = mesh.axis_index(axis_name)
    n_dev = mesh.axis_size(axis_name)
    last = idx == n_dev - 1

    def from_prev(x):
        return mesh.from_prev(x.contiguous(), axis=axis_name)

    def from_next(x):
        return mesh.from_next(x.contiguous(), axis=axis_name)

    end_vel = constraints.end_velocity if use_end_velocity and last else None
    v_hi, q = _bounds(kappas, constraints, v_max_runtime, localised, end_vel)
    v_lo = torch.full((m,), constraints.v_min, dtype=dtype, device=device)
    # one acceleration row a local waypoint; the global last edge does not
    # exist, so its weight is 0 (the row is 0, inside [a_min, a_max])
    a_lo = torch.full((m,), constraints.a_min, dtype=dtype, device=device)
    a_hi = torch.full((m,), constraints.a_max, dtype=dtype, device=device)
    inv2d = 1.0 / (2.0 * distances)
    if last:
        inv2d = torch.cat([inv2d[..., :-1], torch.zeros_like(inv2d[..., -1:])], dim=-1)
    sigma = torch.tensor(cfg.sigma, dtype=dtype, device=device)

    def A_mul(v):
        v_next = torch.cat([v[..., 1:], from_next(v[..., 0])[..., None]], dim=-1)
        return (v_next - v) * inv2d, v

    def AT_mul(w_acc, w_vel):
        g = -w_acc * inv2d
        w_in = from_prev(w_acc[..., -1] * inv2d[..., -1])
        g = g + torch.cat([w_in[..., None], (w_acc * inv2d)[..., :-1]], dim=-1)
        return g + w_vel

    def K_parts(rho):
        w = inv2d**2
        w_prev = torch.cat([from_prev(w[..., -1])[..., None], w[..., :-1]], dim=-1)
        diag = 1.0 + sigma + rho + rho * (w + w_prev)
        return -rho * w_prev, diag, -rho * w  # sub, diag, sup

    def solve(sub, diag, sup, rhs):
        return tridiag_solve_sharded(sub, diag, sup, rhs, mesh, axis_name)

    def residuals(x, za, zv, ya, yv):
        local = _maxima(x, q, za, zv, ya, yv, A_mul, AT_mul)
        return _residual_test(mesh.pmax(local, axis_name), cfg)

    x = torch.zeros((m,), dtype=dtype, device=device) if v0 is None else torch.as_tensor(v0, dtype=dtype, device=device)
    x, status, it, r_p, r_d = _admm_loop(
        x, q, A_mul, AT_mul, K_parts, solve,
        ((a_lo, a_hi), (v_lo, v_hi)), residuals, cfg,
    )
    return SpeedProfileSolution(velocities=x, status=status, iterations=it, r_prim=r_p, r_dual=r_d)
