"""Explicitly-batched box-QP solve.

Counterpart of ``acmpc_tpu/qp/batched.py``: scaling, factorisation and
residuals are batched tensor code, every iteration chunk is one launch of
the ADMM chunk kernel (``ops/admm_chunk.py``) over the whole batch, and
the straggler policy is explicit: finished scenarios FREEZE their
iterates while the rest keep iterating.

Restrictions against the general solver: fixed rho (no adaptive
refactorisation; the MPC configuration runs fixed), primal-infeasibility
certificates and RTI mode supported. Callers that build A as [A_d; I]
solve through :func:`_solve_box_qp_batched` with ``box=True`` (see
``qp/admm.py``).
"""

from __future__ import annotations

import torch

from acmpc_tpu_torch.ops.admm_chunk import admm_chunk
from acmpc_tpu_torch.qp.admm import (
    _INF,
    STATUS_MAX_ITER,
    STATUS_PRIMAL_INFEASIBLE,
    STATUS_SOLVED,
    STATUS_SOLVED_INACCURATE,
    ADMMConfig,
    QPSolution,
    _build_operator,
    _chunk_operator,
    _factor,
    _lane_certificate,
    _lane_residuals,
    _mv,
    _rho_vector,
    _ruiz_equilibrate,
)
from acmpc_tpu_torch.utils.monitor import MONITOR


def solve_box_qp_batched(
    P: torch.Tensor,  # (B, n, n)
    q: torch.Tensor,  # (B, n)
    A: torch.Tensor,  # (B, m, n)
    l: torch.Tensor,  # (B, m)
    u: torch.Tensor,  # (B, m)
    cfg: ADMMConfig = ADMMConfig(),
    x0: torch.Tensor | None = None,
    y0: torch.Tensor | None = None,
) -> QPSolution:
    """Solve B box QPs at once on the device of the inputs."""
    return _solve_box_qp_batched(P, q, A, l, u, cfg, x0, y0, box=False)


def _solve_box_qp_batched(P, q, A, l, u, cfg=ADMMConfig(), x0=None, y0=None, *, box: bool):
    """:func:`solve_box_qp_batched` for a caller that knows A's layout:
    with ``box`` its last n rows are the identity over the n variables."""
    if cfg.adaptive_rho:
        raise ValueError(
            "the batched solver runs fixed rho; use solve_box_qp for adaptive rho"
        )
    dtype, device = q.dtype, q.device
    B, n = q.shape
    m = l.shape[-1]

    # scaling, rho, K and its factorisation, the operator, the first iterates
    with MONITOR.device_span("qp.factor", device):
        l = torch.clamp(l, -_INF, _INF)
        u = torch.clamp(u, -_INF, _INF)

        Ps, qs, As, c, d, e = _ruiz_equilibrate(P, q, A, cfg.scaling_iters)
        ls = e * l
        us = e * u
        As = As.contiguous()
        A_chunk, A_d, g = _chunk_operator(As, box)
        box_kw = {} if g is None else {"g": g, "sigma": cfg.sigma}
        rho_vec = _rho_vector(torch.tensor(cfg.rho, dtype=dtype, device=device), ls, us)
        W, c0 = _build_operator(_factor(Ps, As, rho_vec, cfg.sigma), As, qs, cfg.sigma, A_d)

        x = torch.zeros(B, n, dtype=dtype, device=device) if x0 is None else x0 / d
        y = (
            torch.zeros(B, m, dtype=dtype, device=device)
            if y0 is None
            else c[:, None] * y0 / e
        )
        z = torch.clamp(_mv(As, x), ls, us)

    def chunk(x, z, y, n_iters, active=None):
        return admm_chunk(
            W, A_chunk, c0, rho_vec, ls, us, x, z, y,
            n_iters=n_iters, alpha=cfg.alpha, active=active, **box_kw,
        )

    def residuals(x, y, z):
        return _lane_residuals(cfg, Ps, As, qs, c, d, e, x, y, z)[:4]

    def prim_inf_certificate(dy):
        return _lane_certificate(cfg, As, ls, us, c, d, e, dy)

    def full(value, dtype):
        return torch.full((B,), value, dtype=dtype, device=device)

    if cfg.fixed_iterations is not None:
        with MONITOR.device_span("qp.iterate", device):
            x, z, y = chunk(x, z, y, cfg.fixed_iterations)
            r_p, r_d, converged, near = residuals(x, y, z)
        status = torch.where(
            converged,
            STATUS_SOLVED,
            torch.where(near, STATUS_SOLVED_INACCURATE, STATUS_MAX_ITER),
        ).to(torch.int32)
        return QPSolution(
            x=x * d,
            y=y * e / c[:, None],
            z=z / e,
            status=status,
            iterations=full(cfg.fixed_iterations, torch.int32),
            r_prim=r_p,
            r_dual=r_d,
        )

    it = 0
    done = full(False, torch.bool)
    r_p = full(float("inf"), dtype)
    r_d = full(float("inf"), dtype)
    status = full(STATUS_MAX_ITER, torch.int32)
    its = full(cfg.max_iter, torch.int32)
    with MONITOR.device_span("qp.iterate", device):
        while it < cfg.max_iter:
            with MONITOR.span("qp.read_done"):
                if bool(done.all()):  # host read per chunk
                    break
            # converged scenarios skip the chunk's iterations in the kernel
            active = ~done if cfg.tile_skip else None
            xn, zn, yn = chunk(x, z, y, cfg.check_every, active=active)
            # frozen scenarios keep their converged/certified iterates
            keep = done[:, None]
            xn = torch.where(keep, x, xn)
            zn = torch.where(keep, z, zn)
            yn = torch.where(keep, y, yn)
            it += cfg.check_every
            r_pn, r_dn, converged, near = residuals(xn, yn, zn)
            prim_inf = prim_inf_certificate(yn - y) & ~converged & ~done
            newly_done = (converged | prim_inf) & ~done
            # still-running scenarios carry the near flag, so a max_iter exit
            # reports STATUS_SOLVED_INACCURATE within inaccurate_factor * tol
            status = torch.where(
                newly_done,
                torch.where(converged, STATUS_SOLVED, STATUS_PRIMAL_INFEASIBLE),
                torch.where(
                    ~done & near,
                    STATUS_SOLVED_INACCURATE,
                    torch.where(~done, STATUS_MAX_ITER, status),
                ),
            ).to(torch.int32)
            its = torch.where(newly_done, it, its).to(torch.int32)
            done = done | newly_done
            r_p = torch.where(done & ~newly_done, r_p, r_pn)
            r_d = torch.where(done & ~newly_done, r_d, r_dn)
            x, z, y = xn, zn, yn

    return QPSolution(
        x=x * d,
        y=y * e / c[:, None],
        z=z / e,
        status=status,
        iterations=its,
        r_prim=r_p,
        r_dual=r_d,
    )
