"""Fused ADMM iteration chunk: the CUDA kernel, its plain version and the
wrapper that picks between them by the device of the tensors.

Replaces ``acmpc_tpu/ops/pallas_admm.py`` (``_admm_kernel`` and its
tile-skipping variant ``_admm_kernel_active``). Per scenario b, with a
fixed operator, ``n_iters`` relaxed ADMM iterations:

    xt = W [x; rho*z - y] + c0          W (n, n+m), c0 (n,)
    zt = A xt                           A (m, n)
    x  <- alpha xt + (1 - alpha) x
    zr  = alpha zt + (1 - alpha) z
    z  <- clip(zr + y / rho, l, u)
    y  <- y + rho (zr - z)

Shapes are the true ones (no lane padding): W (B, n, n+m), A (B, m, n),
c0 and x (B, n), rho, l, u, z and y (B, m), all fp32 and contiguous.
``active`` (B,) bool, where given, marks the scenarios that iterate; the
others pass x, z, y through unchanged (the kernel's ``active`` pointer,
the port of ``_admm_kernel_active``, per scenario instead of per tile).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library

KERNEL = "admm_chunk"
KERNEL_ACTIVE = "admm_chunk[active]"


def admm_chunk_reference(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Plain PyTorch version of the chunk, the same six lines per
    iteration as the kernel. Used for CPU tensors and as the kernel's
    yardstick on the card."""
    inv_rho = 1.0 / rho
    x_in, z_in, y_in = x, z, y
    for _ in range(n_iters):
        stacked = torch.cat([x, rho * z - y], dim=-1)
        xt = (W @ stacked[..., None])[..., 0] + c0
        zt = (A @ xt[..., None])[..., 0]
        x_new = alpha * xt + (1.0 - alpha) * x
        z_relax = alpha * zt + (1.0 - alpha) * z
        z_new = torch.clamp(z_relax + y * inv_rho, l, u)
        y = y + rho * (z_relax - z_new)
        x, z = x_new, z_new
    if active is not None:
        keep = ~active[:, None]
        x = torch.where(keep, x_in, x)
        z = torch.where(keep, z_in, z)
        y = torch.where(keep, y_in, y)
    return x, z, y


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    lib = build_library("admm_chunk.cu", torch.device("cuda", device_index))
    fn = lib.admm_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int,  # B
        ctypes.c_int,  # n
        ctypes.c_int,  # m
        ctypes.c_int,  # n_iters
        ctypes.c_float,  # alpha
        ctypes.c_float,  # 1 - alpha
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(W, A, c0, rho, l, u, x, z, y, n_iters, active):
    if W.dim() != 3:
        raise ValueError(f"W must be (B, n, n+m), got {tuple(W.shape)}")
    B, n, k = W.shape
    m = k - n
    expected = {
        "W": (W, (B, n, n + m)),
        "A": (A, (B, m, n)),
        "c0": (c0, (B, n)),
        "rho": (rho, (B, m)),
        "l": (l, (B, m)),
        "u": (u, (B, m)),
        "x": (x, (B, n)),
        "z": (z, (B, m)),
        "y": (y, (B, m)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device}, W on {W.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if active is not None:
        if tuple(active.shape) != (B,) or active.dtype != torch.bool:
            raise ValueError("active must be a (B,) bool tensor")
        if active.device != W.device or not active.is_contiguous():
            raise ValueError("active must be contiguous and on W's device")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    return B, n, m


def admm_chunk(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Run ``n_iters`` fused ADMM iterations for every scenario; returns
    new (x, z, y). CUDA tensors go to the kernel (or the call raises);
    CPU tensors go to :func:`admm_chunk_reference`. ``admm_chunk.launches``
    counts kernel launches by kernel name."""
    B, n, m = _check(W, A, c0, rho, l, u, x, z, y, n_iters, active)
    if W.device.type == "cpu":
        return admm_chunk_reference(
            W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active
        )
    if W.device.type != "cuda":
        raise ValueError(f"admm_chunk runs on cuda or cpu, not {W.device}")

    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if B == 0:
        return x_out, z_out, y_out
    lib = _library(W.device.index)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.admm_chunk_launch(
            W.data_ptr(), A.data_ptr(), c0.data_ptr(), rho.data_ptr(),
            l.data_ptr(), u.data_ptr(), x.data_ptr(), z.data_ptr(),
            y.data_ptr(), None if active is None else active.data_ptr(),
            x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
            B, n, m, int(n_iters), float(alpha), float(1.0 - alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"admm_chunk kernel launch failed: CUDA error {err}")
    admm_chunk.launches[KERNEL if active is None else KERNEL_ACTIVE] += 1
    return x_out, z_out, y_out


admm_chunk.launches = collections.Counter()
