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
scenario. A single scenario with a fixed rho runs its chunk loop through
``ops/graph_loop.device_while``: eagerly one host read of the ``done``
flag per chunk, under a CUDA graph capture (``SpatialMPC.
jitted_get_control``) one WHILE node that the card runs with no host
read. Adaptive rho, and the scenario axis, read the host once a chunk.

Callers that build A as ``[A_d; I]`` (its last n rows the identity over
the variables: the control QP, the raceline) solve through
:func:`_solve_box_qp` with ``box=True``, and the chunks then take the
box block as a diagonal (``_box_block``, ``ops/admm_chunk.py``): the same
iterations on about half the operator's bytes. ``solve_box_qp`` knows
nothing of the layout of the A it is given and takes the dense operator.

``solve_box_qp`` also takes a leading scenario axis, the counterpart of
``jax.vmap(solve_box_qp)`` and of the merge rule that sends the vmapped
solve to the fused kernel: one chunk launch covers every lane, and each
lane keeps the semantics it has alone (its own scaling, iteration count,
status, residuals, infeasibility certificate and adaptive rho). Lanes
that are done skip the chunk's iterations in the kernel and keep their
iterates.

fp32 throughout, with TF32 off (set when the package is imported): TF32
products inject ~1e-3 relative error into the KKT system, which is fatal
for a solver chasing 1e-3 residuals.
"""

from __future__ import annotations

import dataclasses

import torch

from acmpc_tpu_torch.ops.admm_chunk import admm_chunk
from acmpc_tpu_torch.ops.graph_loop import device_while

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


def _build_operator(K_inv, As, qs, sigma, A_d=None):
    """Stacked x-update operator W = [sigma Kinv | Kinv A'] (..., n, n+m)
    and constant c0 = -Kinv q, built once per factorisation. With the box
    block (``A_d``, the rows of A_s before it): W = [Kinv | Kinv A_d']
    (..., n, n + m_d), sigma and the block's diagonal applied in the
    chunk."""
    if A_d is None:
        W = torch.cat([sigma * K_inv, K_inv @ As.transpose(-1, -2)], dim=-1)
    else:
        W = torch.cat([K_inv, K_inv @ A_d.transpose(-1, -2)], dim=-1)
    c0 = -(K_inv @ qs[..., None])[..., 0]
    return W.contiguous(), c0


def _box_block(As, box: bool):
    """(A_d, g) of a scaled A_s = [A_d; diag(g)] whose caller built A as
    [A_d; I], its last n rows the identity over the n variables; None for
    a dense operator (``box`` False). Ruiz scaling multiplies A by
    diagonals, so the block stays diagonal: g is read off it, the floats
    the dense operator would hold."""
    if not box:
        return None
    n = As.shape[-1]
    m_d = As.shape[-2] - n
    g = torch.diagonal(As[..., m_d:, :], dim1=-2, dim2=-1)
    return As[..., :m_d, :].contiguous(), g.contiguous()


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (B, r, c) x (B, c) -> (B, r). On the
    CPU one product per lane, as :func:`_solve_one` computes it (see
    ``ops.admm_chunk._products``)."""
    if M.device.type == "cpu" and len(M):
        return torch.stack([m @ w for m, w in zip(M, v)])
    return (M @ v[..., None])[..., 0]


def _lanewise(fn, *lanes):
    """``fn`` over the leading lane axis of every argument: on the CPU
    lane by lane, as :func:`_solve_one` computes it, stacked; elsewhere
    one batched call. ``fn`` returns a tensor or a tuple of them."""
    if lanes[0].device.type != "cpu" or not len(lanes[0]):
        return fn(*lanes)
    outs = [fn(*lane) for lane in zip(*lanes)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _lane_residuals(cfg, Ps, As, qs, c, d, e, x, y, z):
    """Unscaled residuals, convergence flags and the adaptive-rho ratio of
    B lanes (c (B,), the other vectors (B, .)), each reduced over its own
    lane only. Returns (r_prim, r_dual, converged, near, ratio), (B,)
    each."""
    Ax_u = _mv(As, x) / e
    z_u = z / e
    r_prim = _inf_norm(Ax_u - z_u)
    Px_u = (_mv(Ps, x) / d) / c[:, None]
    Aty_u = (_mv(As.transpose(-1, -2), y) / d) / c[:, None]
    q_u = (qs / d) / c[:, None]
    r_dual = _inf_norm(Px_u + Aty_u + q_u)
    prim_scale = torch.maximum(_inf_norm(Ax_u), _inf_norm(z_u))
    dual_scale = torch.maximum(
        torch.maximum(_inf_norm(Px_u), _inf_norm(Aty_u)), _inf_norm(q_u)
    )
    eps_prim = cfg.eps_abs + cfg.eps_rel * prim_scale
    eps_dual = cfg.eps_abs + cfg.eps_rel * dual_scale
    # divergence guard (see solve_box_qp's residuals)
    sane = torch.isfinite(r_prim) & torch.isfinite(r_dual) & (_inf_norm(x) < 1e12)
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


def _lane_certificate(cfg, As, ls, us, c, d, e, dy):
    """OSQP's primal infeasibility test on each lane's dual-ascent
    direction ``dy`` (B, m), in unscaled quantities; (B,) bool."""
    dy_u_norm = _inf_norm(e * dy) / c
    at_dy = _inf_norm(_mv(As.transpose(-1, -2), dy) / d) / c
    support = (
        torch.sum(us * torch.clamp(dy, min=0.0), dim=-1)
        + torch.sum(ls * torch.clamp(dy, max=0.0), dim=-1)
    ) / c
    eps = cfg.eps_prim_inf * torch.clamp(dy_u_norm, min=1e-30)
    return (dy_u_norm > 1e-12) & (at_dy <= eps) & (support <= -eps)


def _status(converged, near, prim_inf=None):
    s = torch.where(near, STATUS_SOLVED_INACCURATE, STATUS_MAX_ITER)
    if prim_inf is not None:
        s = torch.where(prim_inf, STATUS_PRIMAL_INFEASIBLE, s)
    return torch.where(converged, STATUS_SOLVED, s).to(torch.int32)


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
    """Solve one box QP, or B of them, on the device of the inputs.

    P: (n, n) dense symmetric; q: (n,); A: (m, n); l, u: (m,); x0 (n,)
    and y0 (m,). Or each with a leading scenario axis B: P (B, n, n),
    q (B, n), ..., and every field of the solution (B, ...); lane b is
    the solve of scenario b alone (see :func:`_solve_lanes`).
    Use +/-inf (or +/-1e30) for loose bounds.
    """
    return _solve_box_qp(P, q, A, l, u, cfg, x0, y0, box=False)


def _solve_box_qp(P, q, A, l, u, cfg=ADMMConfig(), x0=None, y0=None, *, box: bool):
    """:func:`solve_box_qp` for a caller that knows A's layout: with
    ``box`` its last n rows are the identity over the n variables (A =
    [A_d; I]), and the chunks take that block as a diagonal."""
    solve = _solve_lanes if q.dim() == 2 else _solve_one
    return solve(P, q, A, l, u, cfg, x0, y0, box)[0]


def _chunk_operator(As, box: bool):
    """(the A a chunk takes, A_d, g): (A_s, None, None) for a dense
    operator, (A_d, A_d, g) with the box block (:func:`_box_block`)."""
    block = _box_block(As, box)
    if block is None:
        return As, None, None
    return block[0], *block


def _solve_one(P, q, A, l, u, cfg, x0, y0, box=False) -> tuple[QPSolution, torch.Tensor]:
    """One QP; returns the solution and the rho it ends on. ``box``: see
    :func:`_solve_box_qp`."""
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
    A_chunk, A_d, g = _chunk_operator(As, box)
    box_kw = {} if g is None else {"g": g[None], "sigma": sigma}

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
            W[None], A_chunk[None], c0[None], rho_vec[None], ls[None], us[None],
            x[None], z[None], y[None], n_iters=n_iters, alpha=cfg.alpha, **box_kw,
        )
        return xo[0], zo[0], yo[0]

    def operator(rho):
        rho_vec = _rho_vector(rho, ls, us)
        return rho_vec, _build_operator(_factor(Ps, As, rho_vec, sigma), As, qs, sigma, A_d)

    def full(value, dtype):
        # filled on the device: a copy from host memory cannot be captured
        return torch.full((), value, dtype=dtype, device=q.device)

    rho = full(cfg.rho, dtype)
    rho_vec, op = operator(rho)

    if cfg.fixed_iterations is not None:
        x, z, y = chunk(x, z, y, rho_vec, op, cfg.fixed_iterations)
        r_p, r_d, converged, near, _ = residuals(x, y, z)
        return QPSolution(
            x=x * d,
            y=y * e / c,
            z=z / e,
            status=_status(converged, near),
            iterations=full(cfg.fixed_iterations, torch.int32),
            r_prim=r_p,
            r_dual=r_d,
        ), rho

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

    def check(x, z, y, rho_vec, op):
        """One chunk and its residual check: the new iterates, the
        residuals, the status, whether the solve is done (converged or
        certified infeasible) and the adaptive-rho ratio."""
        y_before = y
        x, z, y = chunk(x, z, y, rho_vec, op, cfg.check_every)
        r_p, r_d, converged, near, ratio = residuals(x, y, z)
        prim_inf = primal_infeasibility_certificate(y - y_before) & ~converged
        return x, z, y, r_p, r_d, _status(converged, near, prim_inf), converged | prim_inf, ratio

    if not cfg.adaptive_rho:
        # the chunk loop as JAX's lax.while_loop: the stopping test stays
        # on the device (one WHILE node under a CUDA graph capture)
        def body(carry):
            x, z, y, it = carry[:4]
            x, z, y, r_p, r_d, status, done, _ = check(x, z, y, rho_vec, op)
            return x, z, y, it + cfg.check_every, r_p, r_d, status, done

        def cond(carry):
            return ~carry[-1] & (carry[3] < cfg.max_iter)

        inf = float("inf")
        carry = (
            x, z, y, full(0, torch.int32), full(inf, dtype), full(inf, dtype),
            full(STATUS_MAX_ITER, torch.int32), full(False, torch.bool),
        )
        x, z, y, iterations, r_p, r_d, status, _ = device_while(cond, body, carry)
    else:
        # adaptive rho refactors between chunks: the host reads the flags
        it = 0
        done = False
        r_p = r_d = full(float("inf"), dtype)
        status = full(STATUS_MAX_ITER, torch.int32)
        while not done and it < cfg.max_iter:
            x, z, y, r_p, r_d, status, done_t, ratio = check(x, z, y, rho_vec, op)
            it += cfg.check_every
            done = bool(done_t)  # host read, once per chunk
            if not done:
                tol = cfg.adaptive_rho_tol
                if bool((ratio > tol) | (ratio < 1.0 / tol)):
                    rho = torch.clamp(rho * ratio, 1e-6, 1e6)
                    rho_vec, op = operator(rho)
        iterations = full(it, torch.int32)

    return QPSolution(
        x=x * d,
        y=y * e / c,
        z=z / e,
        status=status,
        iterations=iterations,
        r_prim=r_p,
        r_dual=r_d,
    ), rho


def _solve_lanes(P, q, A, l, u, cfg, x0, y0, box=False) -> tuple[QPSolution, torch.Tensor]:
    """B QPs along the leading axis, each lane as :func:`_solve_one`
    solves it alone; returns the solution and the rho (B,) each lane ends
    on. ``box``: see :func:`_solve_box_qp`.

    Scaling, factorisation and the residual checks are batched tensor
    code reduced over each lane's own axis. Every chunk is one
    ``admm_chunk`` call over all lanes: once a lane is done it passes
    ``active = ~done``, so its iterates, iteration count, status and
    residuals stay those of its last chunk. One host read a chunk (is any
    lane still going, is any done, does any lane's rho leave the band);
    a second, the lanes to refactor, only when some lane's does. Those
    lanes alone are refactored and written back into the batch's
    operator: a lane's rho never moves another lane's.
    """
    dtype, device = q.dtype, q.device
    B, n = q.shape
    m = l.shape[-1]

    l = torch.clamp(l, -_INF, _INF)
    u = torch.clamp(u, -_INF, _INF)

    Ps, qs, As, c, d, e = _ruiz_equilibrate(P, q, A, cfg.scaling_iters)
    ls = e * l
    us = e * u
    As = As.contiguous()
    sigma = cfg.sigma
    A_chunk, A_d, g = _chunk_operator(As, box)
    box_kw = {} if g is None else {"g": g, "sigma": sigma}
    # the box block's A_d rides along lane by lane
    lane_A_d = () if A_d is None else (A_d,)

    x = torch.zeros(B, n, dtype=dtype, device=device) if x0 is None else x0 / d
    y = (
        torch.zeros(B, m, dtype=dtype, device=device)
        if y0 is None
        else c[:, None] * y0 / e
    )
    z = torch.clamp(_mv(As, x), ls, us)

    def operator(Ps, As, qs, rho_vec, A_d=None):
        return _build_operator(_factor(Ps, As, rho_vec, sigma), As, qs, sigma, A_d)

    rho = torch.full((B,), cfg.rho, dtype=dtype, device=device)
    rho_vec = _rho_vector(rho[:, None], ls, us)
    W, c0 = _lanewise(operator, Ps, As, qs, rho_vec, *lane_A_d)

    def chunk(x, z, y, n_iters, active=None):
        return admm_chunk(
            W, A_chunk, c0, rho_vec, ls, us, x, z, y,
            n_iters=n_iters, alpha=cfg.alpha, active=active, **box_kw,
        )

    def residuals(x, y, z):
        return _lane_residuals(cfg, Ps, As, qs, c, d, e, x, y, z)

    def solution(x, y, z, status, iterations, r_p, r_d):
        return QPSolution(
            x=x * d,
            y=y * e / c[:, None],
            z=z / e,
            status=status,
            iterations=iterations,
            r_prim=r_p,
            r_dual=r_d,
        )

    def full(value, dtype):
        return torch.full((B,), value, dtype=dtype, device=device)

    if cfg.fixed_iterations is not None:
        x, z, y = chunk(x, z, y, cfg.fixed_iterations)
        r_p, r_d, converged, near, _ = residuals(x, y, z)
        iterations = full(cfg.fixed_iterations, torch.int32)
        return solution(x, y, z, _status(converged, near), iterations, r_p, r_d), rho

    it = 0
    done = full(False, torch.bool)
    any_done = False
    r_p = full(float("inf"), dtype)
    r_d = full(float("inf"), dtype)
    status = full(STATUS_MAX_ITER, torch.int32)
    iterations = full(0, torch.int32)
    while it < cfg.max_iter:
        running = ~done
        x_new, z_new, y_new = chunk(
            x, z, y, cfg.check_every, active=running if any_done else None
        )
        it += cfg.check_every
        r_pn, r_dn, converged, near, ratio = residuals(x_new, y_new, z_new)
        prim_inf = (
            _lane_certificate(cfg, As, ls, us, c, d, e, y_new - y) & ~converged
        )
        # lanes that were done before this chunk keep what they had (the
        # kernel passed their iterates through)
        status = torch.where(running, _status(converged, near, prim_inf), status)
        r_p = torch.where(running, r_pn, r_p)
        r_d = torch.where(running, r_dn, r_d)
        iterations = torch.where(running, iterations + cfg.check_every, iterations)
        x, z, y = x_new, z_new, y_new
        done = done | converged | prim_inf
        flags = [done.all(), done.any()]
        if cfg.adaptive_rho:
            tol = cfg.adaptive_rho_tol
            refactor = ~done & ((ratio > tol) | (ratio < 1.0 / tol))
            flags.append(refactor.any())
        flags = torch.stack(flags).tolist()  # host read, once per chunk
        if flags[0]:
            break
        any_done = flags[1]
        if cfg.adaptive_rho and flags[2]:
            lanes = torch.nonzero(refactor)[:, 0]  # the second read
            rho[lanes] = torch.clamp(rho[lanes] * ratio[lanes], 1e-6, 1e6)
            rv = _rho_vector(rho[lanes, None], ls[lanes], us[lanes])
            W_l, c0_l = _lanewise(
                operator, Ps[lanes], As[lanes], qs[lanes], rv, *(a[lanes] for a in lane_A_d)
            )
            rho_vec[lanes] = rv
            W[lanes] = W_l
            c0[lanes] = c0_l

    return solution(x, y, z, status, iterations, r_p, r_d), rho
