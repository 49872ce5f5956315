"""Distributed tridiagonal solve over a mesh axis (SPIKE).

Counterpart of ``acmpc_tpu/ops/tridiag_sharded.py``. Each rank owns a
contiguous slab of the rows of one global, diagonally dominant
tridiagonal system:

  1. per-block reduction: the rank solves its local block against three
     right-hand sides (its rhs and the two coupling columns into its
     neighbours) with the PCR solve of ``ops/tridiag.py``, which leaves
     two interface unknowns a block;
  2. combine: one all-gather of 6 scalars a rank builds the (2S x 2S)
     interface system (S ranks on the axis), solved on every rank alike
     (``torch.linalg.solve``: the system is tiny and dense);
  3. back-substitution: x = y + v * x_left + w * x_right, elementwise.

Traffic is 6 floats a rank a solve, whatever N. Any leading batch dims.
"""

from __future__ import annotations

import torch

from acmpc_tpu_torch.ops.tridiag import tridiag_solve


def tridiag_solve_sharded(
    sub: torch.Tensor,
    diag: torch.Tensor,
    sup: torch.Tensor,
    rhs: torch.Tensor,
    mesh,
    axis_name: str | None = None,
) -> torch.Tensor:
    """Solve the global tridiagonal system whose rows are sharded as
    contiguous slabs over ``axis_name`` of ``mesh`` (a
    ``parallel.mesh.Mesh``).

    Local shapes are (..., M), row conventions as ``ops/tridiag.py``:
    ``sub[..., 0]`` couples this slab to the last row of the previous one
    (ignored on the first rank), ``sup[..., -1]`` to the first row of the
    next (ignored on the last). Returns this rank's slab of the solution.
    """
    idx = mesh.axis_index(axis_name)
    s = mesh.axis_size(axis_name)
    dtype = rhs.dtype

    # couplings to the neighbours; the last rank's is masked below
    a0 = torch.zeros_like(sub[..., 0]) if idx == 0 else sub[..., 0]
    cm = sup[..., -1]

    # 1. per-block reduction: one batched PCR solve, three right-hand sides
    zero = torch.zeros_like(rhs[..., :1])
    sub_in = torch.cat([zero, sub[..., 1:]], dim=-1)
    sup_in = torch.cat([sup[..., :-1], zero], dim=-1)
    e0 = torch.zeros_like(rhs)
    e0[..., 0] = 1.0
    em = torch.zeros_like(rhs)
    em[..., -1] = 1.0
    rhs3 = torch.stack([rhs, -a0[..., None] * e0, -cm[..., None] * em], dim=0)
    y, v, w = tridiag_solve(
        sub_in.expand(rhs3.shape), diag.expand(rhs3.shape), sup_in.expand(rhs3.shape), rhs3
    )

    # 2. combine: 6 scalars a rank, the interface system on every rank
    vals = torch.stack(
        [y[..., 0], y[..., -1], v[..., 0], v[..., -1], w[..., 0], w[..., -1]], dim=-1
    )
    allv = torch.movedim(mesh.all_gather(vals, axis_name), 0, -2)  # (..., S, 6)
    last_mask = (torch.arange(s, device=rhs.device) < s - 1).to(dtype)
    y_l, y_r = allv[..., 0], allv[..., 1]
    v_l, v_r = allv[..., 2], allv[..., 3]
    w_l, w_r = allv[..., 4] * last_mask, allv[..., 5] * last_mask

    n2 = 2 * s
    batch = y_l.shape[:-1]
    A = torch.eye(n2, dtype=dtype, device=rhs.device).expand(*batch, n2, n2).clone()
    i = torch.arange(s, device=rhs.device)
    row_l, row_r = 2 * i, 2 * i + 1
    col_rp = torch.clamp(2 * i - 1, 0, n2 - 1)  # R_{i-1}; v of rank 0 is 0
    col_ln = torch.clamp(2 * i + 2, 0, n2 - 1)  # L_{i+1}; w of the last is 0
    A[..., row_l, col_rp] -= v_l
    A[..., row_l, col_ln] -= w_l
    A[..., row_r, col_rp] -= v_r
    A[..., row_r, col_ln] -= w_r
    b = torch.stack([y_l, y_r], dim=-1).reshape(*batch, n2)
    u = torch.linalg.solve(A, b[..., None])[..., 0]

    # 3. back-substitution with this rank's interface neighbours
    r_prev = u[..., 2 * idx - 1] if idx > 0 else torch.zeros_like(u[..., 0])
    l_next = u[..., 2 * idx + 2] if idx < s - 1 else torch.zeros_like(u[..., 0])
    return y + v * r_prev[..., None] + w * l_next[..., None]
