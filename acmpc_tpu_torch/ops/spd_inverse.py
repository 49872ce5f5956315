"""Batched SPD inversion built from matmuls.

Counterpart of ``acmpc_tpu/ops/spd_inverse.py``. It inverts K by
recursive block Schur complements,

    K = [[K11, K12], [K12', K22]],   U = K11^-1 K12,   S = K22 - K12' U,
    K^-1 = [[K11^-1 + U S^-1 U', -U S^-1], [-S^-1 U', S^-1]],

halving down to closed-form 2x2 leaves, then takes two guarded
Newton-Schulz polishes (as ``qp/admm._factor``). The JAX package calls it
in place of the Cholesky inverse only on a TPU; the port's ``_factor``
keeps the Cholesky route, and this module is on no path: it is kept for
parity and timed beside ``_factor`` on the card. Plain PyTorch, fp32,
with TF32 off (``acmpc_tpu_torch/__init__.py``).
"""

from __future__ import annotations

import torch


def _inverse_recursive(K: torch.Tensor) -> torch.Tensor:
    """K: (..., n, n) SPD with n a power of 2 (>= 2)."""
    n = K.shape[-1]
    if n <= 2:
        a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 1, 1]
        det = a * c - b * b
        inv = torch.stack(
            [torch.stack([c, -b], dim=-1), torch.stack([-b, a], dim=-1)], dim=-2
        )
        return inv / det[..., None, None]

    h = n // 2
    k11, k12, k22 = K[..., :h, :h], K[..., :h, h:], K[..., h:, h:]
    inv11 = _inverse_recursive(k11)
    u = inv11 @ k12
    s = k22 - k12.transpose(-1, -2) @ u
    inv_s = _inverse_recursive(s)
    top_right = -(u @ inv_s)
    top_left = inv11 - top_right @ u.transpose(-1, -2)
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([top_right.transpose(-1, -2), inv_s], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def spd_inverse(K: torch.Tensor, polish_steps: int = 2) -> torch.Tensor:
    """Explicit inverse of a batched SPD matrix (..., n, n).

    Pads to the next power of 2 with an identity block (its own inverse,
    so slicing back is exact), recurses, then takes ``polish_steps``
    Newton-Schulz corrections M <- M + M(I - KM), each only where it
    contracts (||I - KM||_F < 1).
    """
    n = K.shape[-1]
    np2 = 1 << (n - 1).bit_length()
    if np2 != n:
        K_work = torch.zeros((*K.shape[:-2], np2, np2), dtype=K.dtype, device=K.device)
        K_work[..., :n, :n] = K
        idx = torch.arange(n, np2, device=K.device)
        K_work[..., idx, idx] = 1.0
    else:
        K_work = K

    M = _inverse_recursive(K_work)[..., :n, :n]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    for _ in range(polish_steps):
        R = eye - K @ M
        contracts = torch.sum(R * R, dim=(-2, -1), keepdim=True) < 1.0
        M = torch.where(contracts, M + M @ R, M)
    return M
