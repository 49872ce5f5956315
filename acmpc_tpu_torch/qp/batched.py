"""Explicitly-batched box-QP solve.

Counterpart of ``acmpc_tpu/qp/batched.py``: scaling, factorisation and
residuals are batched tensor code, every iteration chunk is one launch of
the ADMM chunk kernel (``ops/admm_chunk.py``) over the whole batch, and
the straggler policy is explicit: finished scenarios FREEZE their
iterates while the rest keep iterating. The chunk loop runs through
``ops/graph_loop.device_while``: eagerly one host read of the done flags
a chunk, under a CUDA graph capture (``LapSweep.fused_step``) one WHILE
node that the card runs with no host read.

Restrictions against the general solver: fixed rho (no adaptive
refactorisation; the MPC configuration runs fixed), primal-infeasibility
certificates and RTI mode supported. Callers that build A as [A_d; I]
solve through :func:`_solve_box_qp_batched` with ``box=True`` (see
``qp/admm.py``).
"""

from __future__ import annotations

import torch

from acmpc_tpu_torch.ops.graph_loop import device_while
from acmpc_tpu_torch.qp.admm import (
    STATUS_MAX_ITER,
    STATUS_PRIMAL_INFEASIBLE,
    STATUS_SOLVED,
    STATUS_SOLVED_INACCURATE,
    ADMMConfig,
    QPSolution,
    _build_operator,
    _factor,
    _rho_vector,
    _scaled_problem,
    _status,
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

    # scaling, rho, K and its factorisation, the operator, the first iterates
    with MONITOR.device_span("qp.factor", device):
        sp, x, y, z = _scaled_problem(P, q, A, l, u, cfg, x0, y0, box)
        # filled on the device: a copy from host memory cannot be captured
        rho_vec = _rho_vector(torch.full((), cfg.rho, dtype=dtype, device=device), sp.ls, sp.us)
        K_inv = _factor(sp.Ps, sp.As, rho_vec, cfg.sigma)
        W, c0 = _build_operator(K_inv, sp.As, sp.qs, cfg.sigma, sp.A_d)

    if cfg.fixed_iterations is not None:
        with MONITOR.device_span("qp.iterate", device):
            x, z, y = sp.chunk(W, c0, rho_vec, x, z, y, cfg.fixed_iterations)
            r_p, r_d, converged, near, _ = sp.residuals(x, y, z)
        iterations = sp.full(cfg.fixed_iterations, torch.int32)
        return sp.solution(x, y, z, _status(converged, near), iterations, r_p, r_d)

    def body(carry):
        x, z, y, it, done, r_p, r_d, status, its = carry
        # converged scenarios skip the chunk's iterations in the kernel
        active = ~done if cfg.tile_skip else None
        xn, zn, yn = sp.chunk(W, c0, rho_vec, x, z, y, cfg.check_every, active=active)
        # frozen scenarios keep their converged/certified iterates
        keep = done[:, None]
        xn = torch.where(keep, x, xn)
        zn = torch.where(keep, z, zn)
        yn = torch.where(keep, y, yn)
        it = it + cfg.check_every
        r_pn, r_dn, converged, near, _ = sp.residuals(xn, yn, zn)
        prim_inf = sp.certificate(yn - y) & ~converged & ~done
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
        r_p = torch.where(done, r_p, r_pn)
        r_d = torch.where(done, r_d, r_dn)
        done = done | newly_done
        return xn, zn, yn, it, done, r_p, r_d, status, its

    def cond(carry):
        it, done = carry[3], carry[4]
        return ~done.all() & (it < cfg.max_iter)

    # the chunk loop as JAX's lax.while_loop: the stopping test stays on
    # the device (one WHILE node under a CUDA graph capture)
    carry = (
        x, z, y, torch.zeros((), dtype=torch.int32, device=device), sp.full(False, torch.bool),
        sp.full(float("inf"), dtype), sp.full(float("inf"), dtype),
        sp.full(STATUS_MAX_ITER, torch.int32), sp.full(cfg.max_iter, torch.int32),
    )
    with MONITOR.device_span("qp.iterate", device):
        x, z, y, _, _, r_p, r_d, status, its = device_while(cond, body, carry)

    return sp.solution(x, y, z, status, its, r_p, r_d)
