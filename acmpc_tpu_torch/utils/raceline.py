"""Minimum-curvature raceline (offline tool).

Counterpart of ``acmpc_tpu/utils/raceline.py``: the raceline is
centre + alpha * normal with alpha box-bounded by the drivable corridor;
the signed Menger curvature is linearised in alpha and its squared norm
minimised by the package's own ADMM box-QP engine, re-linearising a few
times. Each QP has n = m = N (the track's points) and A = I, the box
block alone, which the chunks take as a diagonal: the operator is K^-1
(N, N), which a cluster holds up to N = 942 (the CLI's 600-point cap),
and the split kernel streams beyond (``ops/admm_chunk.py``).

The Jacobian J = d kappa / d alpha comes from ``torch.func.jacfwd``
(dense (N, N), banded in fact: each curvature sees three points).
Nothing is read back to the host but ``solve_box_qp``'s one flag a chunk
and the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.qp.admm import ADMMConfig, QPSolution, _solve_box_qp

# the QP engine's budget for each re-linearisation, as in the JAX package
RACELINE_ADMM = ADMMConfig(max_iter=2000)


def _unit_normals(centre: torch.Tensor) -> torch.Tensor:
    d = torch.roll(centre, -1, dims=0) - torch.roll(centre, 1, dims=0)
    t = d / torch.clamp(torch.linalg.norm(d, dim=1, keepdim=True), min=1e-9)
    return torch.stack([-t[:, 1], t[:, 0]], dim=1)


def menger_curvature(pts: torch.Tensor) -> torch.Tensor:
    """Menger curvature of every point of a closed polyline, all at once."""
    prev = torch.roll(pts, 1, dims=0)
    nxt = torch.roll(pts, -1, dims=0)
    v21 = prev - pts
    v23 = nxt - pts
    n21 = torch.linalg.norm(v21, dim=1)
    n23 = torch.linalg.norm(v23, dim=1)
    cos_t = torch.clamp(
        torch.sum(v21 * v23, dim=1) / torch.clamp(n21 * n23, min=1e-12), -1.0, 1.0
    )
    sin_t = torch.sin(torch.arccos(cos_t))
    d13 = torch.linalg.norm(v21 - v23, dim=1)
    return 2.0 * sin_t / torch.clamp(d13, min=1e-9)


def signed_curvature(p: torch.Tensor) -> torch.Tensor:
    """Signed Menger curvature in cross-product form: smooth everywhere
    (no arccos), suited to autodiff."""
    prev = torch.roll(p, 1, dims=0)
    nxt = torch.roll(p, -1, dims=0)
    v21 = prev - p
    v23 = nxt - p
    cross = v21[:, 0] * v23[:, 1] - v21[:, 1] * v23[:, 0]
    n21 = torch.linalg.norm(v21, dim=1)
    n23 = torch.linalg.norm(v23, dim=1)
    d13 = torch.linalg.norm(v23 - v21, dim=1)
    return 2.0 * cross / torch.clamp(n21 * n23 * d13, min=1e-9)


def offset_curvature(centre: torch.Tensor, alpha: torch.Tensor, normals: torch.Tensor | None = None) -> torch.Tensor:
    """The signed curvature of the line centre + alpha * normal at every
    point (the centre's unit normals unless given)."""
    if normals is None:
        normals = _unit_normals(centre)
    return signed_curvature(centre + alpha[:, None] * normals)


@dataclasses.dataclass(frozen=True)
class Raceline:
    line: torch.Tensor  # (N, 2)
    alpha: torch.Tensor  # (N,) lateral offset along the centre's normals
    solutions: tuple  # the QPSolution of each re-linearisation


def solve_raceline(
    centre,
    half_width,
    margin: float = 1.0,
    n_iterations: int = 3,
    regularisation: float = 1e-8,
    device: torch.device | str | None = None,
) -> Raceline:
    """The raceline on ``device`` (CUDA unless given), with every QP's
    solution (status, iterations, residuals) left on the device."""
    device = resolve_device(device)
    centre = torch.tensor(np.asarray(centre, np.float32), device=device)
    n = centre.shape[0]
    normals = _unit_normals(centre)
    half = torch.tensor(np.asarray(half_width, np.float32), device=device)
    bound = torch.clamp(half - margin, min=0.0) * torch.ones(n, device=device)
    alpha = torch.zeros(n, device=device)
    solutions: list[QPSolution] = []
    for _ in range(n_iterations):
        qp = raceline_qp(centre, normals, bound, alpha, regularisation)
        sol = _solve_box_qp(*qp, RACELINE_ADMM, box=True)
        solutions.append(sol)
        alpha = sol.x
    return Raceline(centre + alpha[:, None] * normals, alpha, tuple(solutions))


def raceline_qp(centre, normals, bound, alpha, regularisation: float = 1e-8):
    """The box QP (P, q, A, l, u) of one re-linearisation at ``alpha``:
    min ||kappa0 + J (a - alpha)||^2 over the offsets a, |a| <= bound, with
    A = I (the box block alone)."""
    n = centre.shape[0]

    def kappa_of(a):
        return offset_curvature(centre, a, normals)

    kappa0 = kappa_of(alpha)
    J = torch.func.jacfwd(kappa_of)(alpha)
    eye = torch.eye(n, device=centre.device)
    P = 2.0 * (J.T @ J) + regularisation * eye
    q = 2.0 * (J.T @ (kappa0 - J @ alpha))
    # curvatures are ~1e-3-scale, far below the solver's absolute
    # tolerance; rescale the objective (argmin-invariant) so the
    # termination criteria see an O(1) problem
    s = 1.0 / torch.clamp(torch.max(torch.abs(q)), min=1e-12)
    return s * P, s * q, eye, -bound, bound


def calculate_raceline(
    centre,
    half_width,
    margin: float = 1.0,
    n_iterations: int = 3,
    regularisation: float = 1e-8,
    return_alpha: bool = False,
    device: torch.device | str | None = None,
):
    """Minimum-curvature raceline for a closed track.

    centre: (N, 2) ordered closed centreline. half_width: corridor
    half-width per point (scalar or (N,)). Returns the (N, 2) raceline as
    numpy, or ``(raceline, alpha)`` with ``return_alpha``: callers
    optimising on a decimated centreline should transfer the smooth
    lateral offset ``alpha`` onto their dense geometry rather than
    interpolate the coarse polyline.

    Solves min ||kappa0 + J alpha||^2 s.t. |alpha| <= half_width - margin
    with ``qp/admm.solve_box_qp``, re-linearised ``n_iterations`` times.
    """
    r = solve_raceline(centre, half_width, margin, n_iterations, regularisation, device)
    line = r.line.cpu().numpy()
    if return_alpha:
        return line, r.alpha.cpu().numpy()
    return line
