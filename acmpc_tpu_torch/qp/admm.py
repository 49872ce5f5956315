"""First-party ADMM solver for box-constrained QPs.

    minimize    1/2 x'Px + q'x
    subject to  l <= Ax <= u

Counterpart of ``acmpc_tpu/qp/admm.py`` (OSQP's algorithm, Stellato et
al.): Ruiz equilibration, per-constraint step sizes, one explicit inverse
of the KKT x-update matrix, then chunks of relaxed ADMM iterations with
residual checks, adaptive rho, a divergence guard and a primal
infeasibility certificate between chunks.

Every iteration chunk goes through ``ops/admm_chunk.py`` (the CUDA kernel
on the card, its plain PyTorch version on the CPU), also for a single
scenario. The convergence loop runs on the host: one device-to-host read
of the ``done`` flag per chunk.

fp32 throughout, with TF32 off (set when the package is imported): TF32
products inject ~1e-3 relative error into the KKT system, which is fatal
for a solver chasing 1e-3 residuals.
"""

from __future__ import annotations

import dataclasses

import torch

from acmpc_tpu_torch.ops.admm_chunk import admm_chunk

_INF = 1e30  # bounds with |value| >= _INF/1e4 are treated as loose
_MIN_SCALING = 1e-4
_MAX_SCALING = 1e4

STATUS_MAX_ITER = 0
STATUS_SOLVED = 1
STATUS_PRIMAL_INFEASIBLE = 2
# OSQP's "solved inaccurate": the budget ran out with residuals inside
# inaccurate_factor * tolerance (an fp32 engine's dual residual can floor
# within a small multiple of the fp64-calibrated tolerance)
STATUS_SOLVED_INACCURATE = 3


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    # proximal regularisation; 1e-5 rather than OSQP's 1e-6 keeps the fp32
    # KKT inverse accurate enough on the hardest horizon-50 windows
    sigma: float = 1e-5
    rho: float = 0.1
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_prim_inf: float = 1e-4
    # residuals within this multiple of tolerance at max_iter count as
    # STATUS_SOLVED_INACCURATE
    inaccurate_factor: float = 3.0
    max_iter: int = 4000
    # RTI mode: run exactly this many iterations, one residual check at
    # the end (constant step time; warm starts carry progress)
    fixed_iterations: int | None = None
    check_every: int = 25
    scaling_iters: int = 10
    adaptive_rho: bool = True
    adaptive_rho_tol: float = 5.0
    # batched engine only: scenarios that have converged skip the chunk's
    # iterations inside the kernel (their iterates are frozen either way)
    tile_skip: bool = False


@dataclasses.dataclass(frozen=True)
class QPSolution:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    status: torch.Tensor  # int32, STATUS_*
    iterations: torch.Tensor  # int32
    r_prim: torch.Tensor
    r_dual: torch.Tensor

    @property
    def solved(self) -> torch.Tensor:
        return (self.status == STATUS_SOLVED) | (
            self.status == STATUS_SOLVED_INACCURATE
        )


def _inf_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=dim)


def _ruiz_equilibrate(P, q, A, n_iters):
    """Modified Ruiz equilibration of the KKT matrix [[P, A'], [A, 0]] plus
    cost normalisation, batched over leading dimensions. Returns scaled
    (P, q, A) and scalings (c, d, e): P_s = c D P D, q_s = c D q,
    A_s = E A D."""
    d = torch.ones_like(q)
    e = torch.ones_like(A[..., :, 0])
    c = torch.ones_like(q[..., 0])
    for _ in range(n_iters):
        col_norm = torch.maximum(_inf_norm(P, dim=-2), _inf_norm(A, dim=-2))
        row_norm = _inf_norm(A, dim=-1)
        dd = 1.0 / torch.sqrt(torch.clamp(col_norm, _MIN_SCALING, _MAX_SCALING))
        ee = 1.0 / torch.sqrt(torch.clamp(row_norm, _MIN_SCALING, _MAX_SCALING))
        P = P * dd[..., :, None] * dd[..., None, :]
        q = q * dd
        A = A * ee[..., :, None] * dd[..., None, :]
        d = d * dd
        e = e * ee
        # cost normalisation (OSQP sec. 5.1)
        p_cols = torch.mean(_inf_norm(P, dim=-2), dim=-1)
        g = 1.0 / torch.clamp(
            torch.maximum(p_cols, _inf_norm(q)), _MIN_SCALING, _MAX_SCALING
        )
        P = P * g[..., None, None]
        q = q * g[..., None]
        c = c * g
    return P, q, A, c, d, e


def _rho_vector(rho, l, u):
    """Per-constraint step size: equality rows get 1e3*rho, loose rows
    1e-6*rho (OSQP's constraint classification)."""
    loose = (l <= -_INF / 1e4) & (u >= _INF / 1e4)
    eq = (u - l) < 1e-6
    return torch.where(eq, rho * 1e3, torch.where(loose, rho * 1e-6, rho))


def _factor(P, A, rho_vec, sigma):
    """Explicit inverse of K = P + sigma I + A' diag(rho) A, batched.

    Cholesky plus a triangular inverse (library calls), then two GUARDED
    Newton steps M <- M + M(I - KM): each squares the residual
    R = I - KM, recovering the accuracy fp32 Cholesky loses on
    ill-conditioned K, and is taken only where ||R||_F < 1 (where Newton
    contracts). A matrix that is not positive definite gives NaN, which
    the solver's divergence guard reports as not converged.
    """
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    K = P + sigma * eye
    K = K + (A.transpose(-1, -2) * rho_vec[..., None, :]) @ A
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    L_inv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    M = L_inv.transpose(-1, -2) @ L_inv
    for _ in range(2):
        R = eye - K @ M
        contracts = torch.sum(R * R, dim=(-2, -1)) < 1.0
        M = torch.where(contracts[..., None, None], M + M @ R, M)
    return M


def _build_operator(K_inv, As, qs, sigma):
    """Stacked x-update operator W = [sigma Kinv | Kinv A'] (..., n, n+m)
    and constant c0 = -Kinv q, built once per factorisation."""
    W = torch.cat([sigma * K_inv, K_inv @ As.transpose(-1, -2)], dim=-1)
    c0 = -(K_inv @ qs[..., None])[..., 0]
    return W.contiguous(), c0


def solve_box_qp(
    P: torch.Tensor,
    q: torch.Tensor,
    A: torch.Tensor,
    l: torch.Tensor,
    u: torch.Tensor,
    cfg: ADMMConfig = ADMMConfig(),
    x0: torch.Tensor | None = None,
    y0: torch.Tensor | None = None,
) -> QPSolution:
    """Solve one box QP on the device of its inputs.

    P: (n, n) dense symmetric; q: (n,); A: (m, n); l, u: (m,).
    Use +/-inf (or +/-1e30) for loose bounds.
    """
    dtype = q.dtype
    n = q.shape[-1]
    m = l.shape[-1]

    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)

    Ps, qs, As, c, d, e = _ruiz_equilibrate(P, q, A, cfg.scaling_iters)
    ls = e * l
    us = e * u
    As = As.contiguous()
    sigma = cfg.sigma

    x = torch.zeros(n, dtype=dtype, device=q.device) if x0 is None else x0 / d
    y = torch.zeros(m, dtype=dtype, device=q.device) if y0 is None else c * y0 / e
    z = torch.clamp(As @ x, ls, us)

    def residuals(x, y, z):
        """Unscaled residuals, convergence flags and the adaptive-rho
        ratio."""
        Ax_u = (As @ x) / e
        z_u = z / e
        r_prim = _inf_norm(Ax_u - z_u)
        Px_u = ((Ps @ x) / d) / c
        Aty_u = ((As.T @ y) / d) / c
        q_u = (qs / d) / c
        r_dual = _inf_norm(Px_u + Aty_u + q_u)
        prim_scale = torch.maximum(_inf_norm(Ax_u), _inf_norm(z_u))
        dual_scale = torch.maximum(
            torch.maximum(_inf_norm(Px_u), _inf_norm(Aty_u)), _inf_norm(q_u)
        )
        eps_prim = cfg.eps_abs + cfg.eps_rel * prim_scale
        eps_dual = cfg.eps_abs + cfg.eps_rel * dual_scale
        # divergence guard: a blown-up fp32 iterate inflates its own
        # relative tolerance or goes NaN; a sane iterate after Ruiz
        # scaling is O(1)
        sane = (
            torch.isfinite(r_prim) & torch.isfinite(r_dual) & (_inf_norm(x) < 1e12)
        )
        converged = (r_prim <= eps_prim) & (r_dual <= eps_dual) & sane
        near = (
            (r_prim <= cfg.inaccurate_factor * eps_prim)
            & (r_dual <= cfg.inaccurate_factor * eps_dual)
            & sane
        )
        prim_n = r_prim / torch.clamp(prim_scale, min=1e-10)
        dual_n = r_dual / torch.clamp(dual_scale, min=1e-10)
        ratio = torch.sqrt(prim_n / torch.clamp(dual_n, min=1e-10))
        return r_prim, r_dual, converged, near, ratio

    def chunk(x, z, y, rho_vec, op, n_iters):
        W, c0 = op
        xo, zo, yo = admm_chunk(
            W[None], As[None], c0[None], rho_vec[None], ls[None], us[None],
            x[None], z[None], y[None], n_iters=n_iters, alpha=cfg.alpha,
        )
        return xo[0], zo[0], yo[0]

    def operator(rho):
        rho_vec = _rho_vector(rho, ls, us)
        return rho_vec, _build_operator(_factor(Ps, As, rho_vec, sigma), As, qs, sigma)

    def status_of(converged, near, prim_inf=None):
        s = torch.where(near, STATUS_SOLVED_INACCURATE, STATUS_MAX_ITER)
        if prim_inf is not None:
            s = torch.where(prim_inf, STATUS_PRIMAL_INFEASIBLE, s)
        return torch.where(converged, STATUS_SOLVED, s).to(torch.int32)

    rho = torch.tensor(cfg.rho, dtype=dtype, device=q.device)
    rho_vec, op = operator(rho)

    if cfg.fixed_iterations is not None:
        x, z, y = chunk(x, z, y, rho_vec, op, cfg.fixed_iterations)
        r_p, r_d, converged, near, _ = residuals(x, y, z)
        return QPSolution(
            x=x * d,
            y=y * e / c,
            z=z / e,
            status=status_of(converged, near),
            iterations=torch.tensor(
                cfg.fixed_iterations, dtype=torch.int32, device=q.device
            ),
            r_prim=r_p,
            r_dual=r_d,
        )

    def primal_infeasibility_certificate(dy):
        """OSQP's test on a dual-ascent direction delta_y (Stellato et al.
        sec. 3.4), in unscaled quantities."""
        dy_u_norm = _inf_norm(e * dy) / c
        at_dy = _inf_norm((As.T @ dy) / d) / c
        support = (
            torch.sum(us * torch.clamp(dy, min=0.0))
            + torch.sum(ls * torch.clamp(dy, max=0.0))
        ) / c
        eps = cfg.eps_prim_inf * torch.clamp(dy_u_norm, min=1e-30)
        return (dy_u_norm > 1e-12) & (at_dy <= eps) & (support <= -eps)

    it = 0
    done = False
    r_p = r_d = torch.tensor(float("inf"), dtype=dtype, device=q.device)
    status = torch.tensor(STATUS_MAX_ITER, dtype=torch.int32, device=q.device)
    while not done and it < cfg.max_iter:
        y_before = y
        x, z, y = chunk(x, z, y, rho_vec, op, cfg.check_every)
        it += cfg.check_every
        r_p, r_d, converged, near, ratio = residuals(x, y, z)
        prim_inf = primal_infeasibility_certificate(y - y_before) & ~converged
        status = status_of(converged, near, prim_inf)
        done = bool(converged | prim_inf)  # host read, once per chunk
        if cfg.adaptive_rho and not done:
            tol = cfg.adaptive_rho_tol
            if bool((ratio > tol) | (ratio < 1.0 / tol)):
                rho = torch.clamp(rho * ratio, 1e-6, 1e6)
                rho_vec, op = operator(rho)

    return QPSolution(
        x=x * d,
        y=y * e / c,
        z=z / e,
        status=status,
        iterations=torch.tensor(it, dtype=torch.int32, device=q.device),
        r_prim=r_p,
        r_dual=r_d,
    )
