"""Tridiagonal linear systems: a product and a parallel-cyclic-reduction
solve.

Counterpart of ``acmpc_tpu/ops/tridiag.py``. The speed-profile ADMM's
x-update is a symmetric, strictly diagonally dominant tridiagonal solve
(``qp/speed_profile.py``). Parallel cyclic reduction (PCR) takes
ceil(log2 N) steps of elementwise work with no sequential recurrence;
out-of-range neighbours act as identity rows (a = 0, b = 1, c = 0,
d = 0), so every step is a no-op there. Plain PyTorch, fp32, any
leading batch dims.
"""

from __future__ import annotations

import math

import torch


def tridiag_matvec(
    sub: torch.Tensor, diag: torch.Tensor, sup: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """y = T x for T tridiagonal.

    ``sub``/``sup`` have shape (..., N) with sub[..., 0] and sup[..., -1]
    ignored: row i is ``sub[i]*x[i-1] + diag[i]*x[i] + sup[i]*x[i+1]``.
    """
    zero = torch.zeros_like(x[..., :1])
    lower = torch.cat([zero, sub[..., 1:] * x[..., :-1]], dim=-1)
    upper = torch.cat([sup[..., :-1] * x[..., 1:], zero], dim=-1)
    return lower + diag * x + upper


def _shift_right(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x[i] <- x[i-s], with ``fill`` for i < s."""
    return torch.cat([torch.full_like(x[..., :s], fill), x[..., :-s]], dim=-1)


def _shift_left(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x[i] <- x[i+s], with ``fill`` for i >= N-s."""
    return torch.cat([x[..., s:], torch.full_like(x[..., :s], fill)], dim=-1)


def tridiag_solve(
    sub: torch.Tensor,
    diag: torch.Tensor,
    sup: torch.Tensor,
    rhs: torch.Tensor,
) -> torch.Tensor:
    """Solve T x = rhs by parallel cyclic reduction.

    Stable for diagonally dominant systems (the QP engine's exceed
    |sub| + |sup| by at least sigma + rho). Shapes as in
    :func:`tridiag_matvec`.
    """
    n = rhs.shape[-1]
    if n == 1:
        return rhs / diag

    a = torch.cat([torch.zeros_like(sub[..., :1]), sub[..., 1:]], dim=-1)
    c = torch.cat([sup[..., :-1], torch.zeros_like(sup[..., :1])], dim=-1)
    b = diag
    d = rhs
    for step in range(max(1, math.ceil(math.log2(n)))):
        s = 1 << step
        if s >= n:
            break
        alpha = -a / _shift_right(b, s, 1.0)
        beta = -c / _shift_left(b, s, 1.0)
        a_next = alpha * _shift_right(a, s, 0.0)
        c_next = beta * _shift_left(c, s, 0.0)
        b = b + alpha * _shift_right(c, s, 0.0) + beta * _shift_left(a, s, 0.0)
        d = d + alpha * _shift_right(d, s, 0.0) + beta * _shift_left(d, s, 0.0)
        a, c = a_next, c_next
    return d / b
