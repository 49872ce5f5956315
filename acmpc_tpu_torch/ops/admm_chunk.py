"""Fused ADMM iteration chunk: the CUDA kernels, their plain version and
the wrapper that picks between them.

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
others pass x, z, y through unchanged (the port of
``_admm_kernel_active``, per scenario instead of per tile).

Two CUDA kernels compute it, chosen by :func:`plan_chunk` from (n, m, B)
before launch:

* ``cluster`` (``csrc/admm_chunk.cu``): one thread-block cluster of C
  CTAs per scenario, the operator held in the cluster's shared memory for
  the whole chunk;
* ``stream`` (``csrc/admm_chunk_stream.cu``): one block per scenario, W
  and A read from global memory every iteration; for operators that no
  cluster can hold (the mapping control at horizon 100).

CPU tensors go to :func:`admm_chunk_reference`; CUDA tensors go to the
planned kernel, and a refused launch raises.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import dataclasses
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library

CLUSTER = "admm_chunk_cluster"
CLUSTER_ACTIVE = "admm_chunk_cluster[active]"
STREAM = "admm_chunk_stream"
STREAM_ACTIVE = "admm_chunk_stream[active]"
KERNEL_NAMES = (CLUSTER, CLUSTER_ACTIVE, STREAM, STREAM_ACTIVE)
SOURCES = {"cluster": "admm_chunk.cu", "stream": "admm_chunk_stream.cu"}

# H100: shared memory one block may use, and the largest cluster (above
# 8 CTAs only with the non-portable opt-in)
SMEM_PER_BLOCK = 232_448
MAX_CLUSTER = 16
# clusters of 8 CTAs that an H100 holds at once (its GPCs; measured with
# cudaOccupancyMaxActiveClusters by chip_smoke.py phase 3)
CLUSTERS_OF_8 = 15


def admm_chunk_reference(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Plain PyTorch version of the chunk, the same six lines per
    iteration as the kernels. Used for CPU tensors and as the kernels'
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


def cluster_smem_bytes(n: int, m: int, C: int) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel with C CTAs
    per scenario (the layout of ``csrc/admm_chunk.cu``): four mbarriers
    (32 bytes); the CTA's W and A row slices, each with 3 floats of room
    for its alignment shift and rounded to 4 floats; the full [x; w] and
    xt; c0 and x of its W rows; z, y, rho, 1/rho, l, u of its A rows."""

    def round4(v):
        return (v + 3) & ~3

    rows_w, rows_a = -(-n // C), -(-m // C)
    floats = (
        round4(rows_w * (n + m) + 3)
        + round4(rows_a * n + 3)
        + (n + m)
        + n
        + 2 * rows_w
        + 6 * rows_a
    )
    return 32 + 4 * floats


def stream_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one block of the streaming kernel: the
    vectors x, w, xt, c0, z, y, rho, 1/rho, l, u."""
    return 4 * (3 * n + 7 * m)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    variant: str  # "cluster" or "stream"
    cluster: int  # CTAs per scenario; 1 for "stream"
    smem_bytes: int  # dynamic shared memory per CTA


def plan_chunk(n: int, m: int, B: int) -> ChunkPlan:
    """Which kernel runs a chunk of B scenarios at (n, m), from the shapes
    alone. The cluster kernel with the fewest CTAs that hold their slices
    in shared memory (c_min: 5 at horizon 50), so that the most
    scenarios run at once; but where 8-CTA clusters hold all B scenarios
    in one wave, at least 8 CTAs, to spread each scenario's chain over
    more SMs (16 CTAs measured within 10% of 8 at B = 1 and B = 7, and
    the card holds fewer than half as many at once). Shapes that no
    cluster of 16 holds take the streaming kernel."""
    fitting = [
        C for C in range(1, MAX_CLUSTER + 1)
        if cluster_smem_bytes(n, m, C) <= SMEM_PER_BLOCK
    ]
    if not fitting:
        return ChunkPlan("stream", 1, stream_smem_bytes(n, m))
    C = fitting[0]
    if B <= CLUSTERS_OF_8:
        C = max(C, 8)
    return ChunkPlan("cluster", C, cluster_smem_bytes(n, m, C))


_PTR = ctypes.c_void_p
_LAUNCH_TAIL = {
    "cluster": [ctypes.c_int] * 5,  # B, n, m, C, n_iters
    "stream": [ctypes.c_int] * 4,  # B, n, m, n_iters
}


@functools.lru_cache(maxsize=None)
def _libraries(device_index: int) -> dict:
    """Both kernels' libraries for one card, built side by side."""
    device = torch.device("cuda", device_index)
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {
            v: pool.submit(build_library, src, device) for v, src in SOURCES.items()
        }
        libs = {v: f.result() for v, f in futures.items()}
    for variant, lib in libs.items():
        fn = getattr(lib, f"admm_chunk_{variant}_launch")
        fn.argtypes = [_PTR] * 13 + _LAUNCH_TAIL[variant] + [
            ctypes.c_float,  # alpha
            ctypes.c_float,  # 1 - alpha
            _PTR,  # stream
        ]
        fn.restype = ctypes.c_int
    smem = libs["cluster"].admm_chunk_cluster_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    active = libs["cluster"].admm_chunk_cluster_max_active
    active.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    active.restype = ctypes.c_int
    return libs


@functools.lru_cache(maxsize=None)
def cluster_max_active(n: int, m: int, C: int, device_index: int) -> int:
    """How many clusters of C CTAs at (n, m) the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    lib = _libraries(device_index)["cluster"]
    with torch.cuda.device(device_index):
        err = lib.admm_chunk_cluster_max_active(n, m, C, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error {err}")
    return count.value


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


def _launch(plan: ChunkPlan, W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Launch ``plan``'s kernel on checked CUDA tensors and count it in
    ``admm_chunk.launches``; returns new (x, z, y). Raises where the
    card cannot schedule the cluster or refuses the launch."""
    B, n = x.shape
    m = z.shape[1]
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if B == 0:
        return x_out, z_out, y_out
    index = W.device.index
    lib = _libraries(index)[plan.variant]
    if plan.variant == "cluster" and cluster_max_active(n, m, plan.cluster, index) == 0:
        raise RuntimeError(
            f"the card cannot schedule a cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} bytes of shared memory each"
        )
    shape = (B, n, m, plan.cluster) if plan.variant == "cluster" else (B, n, m)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = getattr(lib, f"admm_chunk_{plan.variant}_launch")(
            W.data_ptr(), A.data_ptr(), c0.data_ptr(), rho.data_ptr(),
            l.data_ptr(), u.data_ptr(), x.data_ptr(), z.data_ptr(),
            y.data_ptr(), None if active is None else active.data_ptr(),
            x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
            *shape, int(n_iters), float(alpha), float(1.0 - alpha), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"admm_chunk {plan.variant} kernel launch failed: CUDA error {err}"
        )
    name = CLUSTER if plan.variant == "cluster" else STREAM
    admm_chunk.launches[name if active is None else f"{name}[active]"] += 1
    return x_out, z_out, y_out


def admm_chunk(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Run ``n_iters`` fused ADMM iterations for every scenario; returns
    new (x, z, y). CUDA tensors go to the kernel that :func:`plan_chunk`
    picks (or the call raises); CPU tensors go to
    :func:`admm_chunk_reference`. ``admm_chunk.launches`` counts kernel
    launches by the names in ``KERNEL_NAMES``."""
    B, n, m = _check(W, A, c0, rho, l, u, x, z, y, n_iters, active)
    if W.device.type == "cpu":
        return admm_chunk_reference(
            W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active
        )
    if W.device.type != "cuda":
        raise ValueError(f"admm_chunk runs on cuda or cpu, not {W.device}")
    return _launch(
        plan_chunk(n, m, B), W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active
    )


admm_chunk.launches = collections.Counter()
