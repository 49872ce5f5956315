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

The box block. Where the QP's A ends in an identity over its n variables
(the control QP's ``[A_eq; I]``, the raceline's ``I``), Ruiz scaling
keeps that block diagonal, ``A_s = [A_d; diag(g)]``, and the x-update's
last n columns are ``K^-1 diag(g)``: the same K^-1 as its first block.
Given ``g`` (B, n) and ``sigma``, the chunk takes the operator so:
W (B, n, n + m_d) is ``[K^-1 | K^-1 A_d']``, A (B, m_d, n) is A_d, the
vectors keep all m = m_d + n rows (dense rows first, box row m_d + i that
of variable i), and per iteration

    xt   = W [sigma x + g (rho_b z_b - y_b); rho_d z_d - y_d] + c0
    zt   = [A_d xt; g xt]

with the relax, clip and dual update above. Without ``g`` the operator
is the dense one, as the TPU kernel takes it.

Two CUDA kernels compute it; :func:`plan_chunk` picks one from (n, m, B)
before launch:

* ``cluster`` (``csrc/admm_chunk.cu``): one thread-block cluster of C
  CTAs per scenario, the operator held in the cluster's shared memory for
  the whole chunk (with the box block: every control QP up to horizon
  100 and the raceline up to ~640 points);
* ``split`` (``csrc/admm_chunk_split.cu``): for operators that no cluster
  holds whole (dense: horizons above 92; with the box block: the raceline
  at 1,953 points): a cluster of C CTAs per scenario keeps as many rows
  as fit in shared memory and streams the rest from L2 every iteration
  through a ring of shared-memory stages.

CPU tensors go to :func:`admm_chunk_reference` (with the box block
:func:`admm_chunk_box_reference`); CUDA tensors go to the planned kernel,
and a refused launch raises.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import dataclasses
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

CLUSTER = "admm_chunk_cluster"
CLUSTER_ACTIVE = "admm_chunk_cluster[active]"
SPLIT = "admm_chunk_split"
SPLIT_ACTIVE = "admm_chunk_split[active]"
CLUSTER_BOX = "admm_chunk_cluster[box]"
CLUSTER_BOX_ACTIVE = "admm_chunk_cluster[box,active]"
SPLIT_BOX = "admm_chunk_split[box]"
SPLIT_BOX_ACTIVE = "admm_chunk_split[box,active]"
KERNEL_NAMES = (
    CLUSTER, CLUSTER_ACTIVE, SPLIT, SPLIT_ACTIVE,
    CLUSTER_BOX, CLUSTER_BOX_ACTIVE, SPLIT_BOX, SPLIT_BOX_ACTIVE,
)
SOURCES = {
    "cluster": "admm_chunk.cu",
    "split": "admm_chunk_split.cu",
}

# H100: shared memory one block may use, and the largest cluster (above
# 8 CTAs only with the non-portable opt-in)
SMEM_PER_BLOCK = 232_448
MAX_CLUSTER = 16
# clusters of 8 CTAs that an H100 holds at once (its GPCs; measured with
# cudaOccupancyMaxActiveClusters by chip_smoke.py phase 3)
CLUSTERS_OF_8 = 15
# consumer warps of a cluster or split CTA (csrc/admm_chunk_common.cuh)
WARPS = 16
# the split kernel's ring: stages, and bytes of one stage (raised to one
# W row where that is longer)
SPLIT_STAGES = 4
SPLIT_STAGE_BYTES = 8192


def _products(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, r, c) x (B, c) -> (B, r). On the CPU one product per scenario,
    each as a batch of one computes it: a batched matrix-vector product
    there rounds otherwise than a single one, and a scenario of a batch
    is held bit for bit against the same scenario solved alone."""
    if M.device.type == "cpu" and len(M) > 1:
        return torch.cat([_products(M[b : b + 1], v[b : b + 1]) for b in range(len(M))])
    return (M @ v[..., None])[..., 0]


def admm_chunk_reference(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None):
    """Plain PyTorch version of the chunk, the same six lines per
    iteration as the kernels. Used for CPU tensors and as the kernels'
    yardstick on the card."""
    inv_rho = 1.0 / rho
    x_in, z_in, y_in = x, z, y
    for _ in range(n_iters):
        stacked = torch.cat([x, rho * z - y], dim=-1)
        xt = _products(W, stacked) + c0
        zt = _products(A, xt)
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


def admm_chunk_box_reference(
    W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None, *, g, sigma
):
    """Plain PyTorch version of the chunk on the box block's operator
    (the module's docstring): W (B, n, n + m_d), A (B, m_d, n), g (B, n)
    and the scalar ``sigma``. Used for CPU tensors and as the [box]
    kernels' yardstick on the card."""
    m_d = A.shape[1]
    inv_rho = 1.0 / rho
    x_in, z_in, y_in = x, z, y
    for _ in range(n_iters):
        w = rho * z - y
        stacked = torch.cat([sigma * x + g * w[:, m_d:], w[:, :m_d]], dim=-1)
        xt = _products(W, stacked) + c0
        zt = torch.cat([_products(A, xt), g * xt], dim=-1)
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


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _dense_rows(n: int, m: int, n_b: int) -> int:
    """m_d, the rows of A the kernels read, of m constraints whose last
    n_b (n or 0) are the box block."""
    if n_b not in (0, n) or m < n_b:
        raise ValueError(f"the box block spans all {n} variables or none, got n_b={n_b}, m={m}")
    return m - n_b


def cluster_smem_bytes(n: int, m: int, C: int, n_b: int = 0) -> int:
    """Dynamic shared memory of one CTA of the cluster kernel with C CTAs
    per scenario (the layout of ``csrc/admm_chunk.cu``) for m constraints
    of which the last n_b are the box block (n or 0): four mbarriers (32
    bytes); the CTA's W and A row slices (m_d = m - n_b rows of A, n + m_d
    columns of W), each with 3 floats of room for its alignment shift and
    rounded to 4 floats; the full [x; w] and xt; c0 and x of its W rows;
    z, y, rho, 1/rho, l, u of its A rows; with the box block, g, z, y,
    rho, 1/rho, l, u and the stacked value of its W rows' box rows."""
    m_d = _dense_rows(n, m, n_b)
    rows_w, rows_a = -(-n // C), -(-m_d // C)
    floats = (
        _round4(rows_w * (n + m_d) + 3)
        + _round4(rows_a * n + 3)
        + (n + m_d)
        + n
        + 2 * rows_w
        + 6 * rows_a
        + (8 * rows_w if n_b else 0)
    )
    return 32 + 4 * floats


@dataclasses.dataclass(frozen=True)
class SplitLayout:
    rows_w: int  # W rows per CTA (the last CTAs may hold fewer)
    rows_a: int  # A rows per CTA
    res_w: int  # of those, rows held in shared memory
    res_a: int
    stage_floats: int  # one ring stage
    per_stage_w: int  # whole W rows in one stage
    per_stage_a: int  # whole A rows in one stage
    bytes: int  # dynamic shared memory per CTA


@functools.lru_cache(maxsize=None)
def split_layout(
    n: int,
    m: int,
    C: int,
    stages: int = SPLIT_STAGES,
    stage_bytes: int = SPLIT_STAGE_BYTES,
    n_b: int = 0,
) -> SplitLayout:
    """The split kernel's layout (``csrc/admm_chunk_split.cu``) with C
    CTAs per scenario and a ring of ``stages`` stages, for m constraints
    of which the last n_b (n or 0) are the box block: 4 + 2 * stages
    mbarriers and a fill number per stage, 8 bytes each and rounded to 16
    bytes; the resident W and A rows (m_d = m - n_b rows of A, n + m_d
    columns of W), each region with 3 floats of room for its alignment
    shift and rounded to 4 floats; the ring; an edge table of 8 floats per
    streamed stage; the vectors of the cluster kernel. The most resident
    rows that fit in SMEM_PER_BLOCK: all, then one A row fewer at a time,
    then one W row fewer at a time; ``bytes`` is above SMEM_PER_BLOCK
    where not even the vectors and the ring fit. The rows of each slice
    after the resident ones stream, ``per_stage_*`` to a stage."""
    m_d = _dense_rows(n, m, n_b)
    k_w = n + m_d
    rows_w, rows_a = -(-n // C), -(-m_d // C)
    stage_floats = _round4(max(stage_bytes // 4, k_w + 3))
    per_w = min(WARPS, (stage_floats - 3) // k_w)
    per_a = min(WARPS, (stage_floats - 3) // n)

    def size(res_w, res_a):
        streamed = -(-(rows_w - res_w) // per_w) + -(-(rows_a - res_a) // per_a)
        floats = (
            _round4(res_w * k_w + 3)
            + _round4(res_a * n + 3)
            + stages * stage_floats
            + 8 * streamed
            + k_w
            + n
            + 2 * rows_w
            + 6 * rows_a
            + (8 * rows_w if n_b else 0)
        )
        return (8 * (4 + 3 * stages) + 15) // 16 * 16 + 4 * floats

    res_w, res_a = rows_w, rows_a
    while size(res_w, res_a) > SMEM_PER_BLOCK and (res_a > 0 or res_w > 0):
        if res_a > 0:
            res_a -= 1
        else:
            res_w -= 1
    return SplitLayout(
        rows_w, rows_a, res_w, res_a, stage_floats, per_w, per_a, size(res_w, res_a)
    )


def split_smem_bytes(
    n: int,
    m: int,
    C: int,
    stages: int = SPLIT_STAGES,
    stage_bytes: int = SPLIT_STAGE_BYTES,
    n_b: int = 0,
) -> int:
    """Dynamic shared memory of one CTA of the split kernel."""
    return split_layout(n, m, C, stages, stage_bytes, n_b).bytes


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    variant: str  # "cluster" or "split"
    cluster: int  # CTAs per scenario
    smem_bytes: int  # dynamic shared memory per CTA
    stages: int = 0  # "split": ring stages
    stage_bytes: int = 0  # "split": bytes of one stage
    box: bool = False  # the operator comes with the box block (g)


def split_plan(
    n: int,
    m: int,
    C: int,
    stages: int = SPLIT_STAGES,
    stage_bytes: int = SPLIT_STAGE_BYTES,
    n_b: int = 0,
) -> ChunkPlan:
    return ChunkPlan(
        "split",
        C,
        split_smem_bytes(n, m, C, stages, stage_bytes, n_b),
        stages,
        stage_bytes,
        bool(n_b),
    )


def cluster_plan(n: int, m: int, C: int, n_b: int = 0) -> ChunkPlan:
    return ChunkPlan("cluster", C, cluster_smem_bytes(n, m, C, n_b), box=bool(n_b))


def plan_chunk(n: int, m: int, B: int, n_b: int = 0) -> ChunkPlan:
    """Which kernel runs a chunk of B scenarios at (n, m), from the shapes
    alone; n_b (n or 0) of the m constraints are the box block. The cluster kernel with the fewest CTAs that hold their slices
    in shared memory (c_min: 5 at horizon 50), so that the most
    scenarios run at once; but where 8-CTA clusters hold all B scenarios
    in one wave, at least 8 CTAs, to spread each scenario's chain over
    more SMs (16 CTAs measured within 10% of 8 at B = 1 and B = 7, and
    the card holds fewer than half as many at once). Shapes that no
    cluster of 16 holds take the split kernel with 16 CTAs and its
    default ring (4 stages of 8 KB): at horizon 100 each CTA then streams
    76 KB per iteration, against 339 KB at C = 8. Measured on an H100
    (bench/chunk_sweep.py): C = 16 iterates in 6.3 us at B = 1 and
    12.6 us at B = 8, where the card holds 7 of its clusters at once and
    so runs two waves; C = 8 holds 15 clusters at once, runs B = 8 in one
    wave, and iterates in 20.8 us at either B; every C from 9 to 15 lies
    between them. Rings of 2 x 16 KB were within 2%, 2 x 8 KB, 8 x 8 KB
    and 4 x 16 KB 5-13% slower, 8 x 4 KB 1.9x slower. The rule is the
    same with the box block (n_b = n): C = 3 at horizon 50 (0.79 ms at B
    = 256 against 1.20 dense; C = 4 measured 3.5% faster), 8 below B =
    16; 10 at horizon 100 at any B (C = 12-16 measured 10% faster: every
    cluster above 8 CTAs holds 7 at once); the split kernel past 942
    raceline points."""
    fitting = [
        C for C in range(1, MAX_CLUSTER + 1)
        if cluster_smem_bytes(n, m, C, n_b) <= SMEM_PER_BLOCK
    ]
    if not fitting:
        plan = split_plan(n, m, MAX_CLUSTER, n_b=n_b)
        if plan.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(f"no chunk kernel takes n={n}, m={m}: the vectors do not fit")
        return plan
    C = fitting[0]
    if B <= CLUSTERS_OF_8:
        C = max(C, 8)
    return cluster_plan(n, m, C, n_b)


_PTR = ctypes.c_void_p
# pointers (g after c0), the ints after them, the floats (alpha,
# 1 - alpha, sigma)
_LAUNCH_ARGS = {
    "cluster": (14, 5, 3),  # B, n, m, C, n_iters
    "split": (14, 7, 3),  # B, n, m, C, stages, stage_bytes, n_iters
}


@functools.lru_cache(maxsize=None)
def _libraries(device_index: int) -> dict:
    """The kernels' libraries for one card, built side by side."""
    device = torch.device("cuda", device_index)
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {
            v: pool.submit(build_library, src, device) for v, src in SOURCES.items()
        }
        libs = {v: f.result() for v, f in futures.items()}
    for variant, lib in libs.items():
        fn = getattr(lib, f"admm_chunk_{variant}_launch")
        pointers, ints, floats = _LAUNCH_ARGS[variant]
        fn.argtypes = [_PTR] * pointers + [ctypes.c_int] * ints + [ctypes.c_float] * floats + [
            _PTR  # stream
        ]
        fn.restype = ctypes.c_int
    int_p = ctypes.POINTER(ctypes.c_int)
    # getattr, not [], so that the settings stay on the cached function
    for variant, shape in (("cluster", 4), ("split", 6)):  # n, m, C[, S, bytes], box
        smem = getattr(libs[variant], f"admm_chunk_{variant}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * shape
        smem.restype = ctypes.c_longlong
        active = getattr(libs[variant], f"admm_chunk_{variant}_max_active")
        active.argtypes = [ctypes.c_int] * shape + [int_p]
        active.restype = ctypes.c_int
    rows = libs["split"].admm_chunk_split_resident_rows
    rows.argtypes = [ctypes.c_int] * 6 + [int_p, int_p]
    rows.restype = None
    return libs


def _layout_args(plan: ChunkPlan) -> tuple:
    """The launch's layout arguments after (n, m): C[, stages, bytes]."""
    if plan.variant == "split":
        return plan.cluster, plan.stages, plan.stage_bytes
    return (plan.cluster,)


def kernel_name(plan: ChunkPlan, masked: bool) -> str:
    """The launch counter of ``plan``'s kernel: ``KERNEL_NAMES``."""
    tags = ["box"] * plan.box + ["active"] * masked
    return f"admm_chunk_{plan.variant}" + (f"[{','.join(tags)}]" if tags else "")


@functools.lru_cache(maxsize=None)
def max_active_clusters(plan: ChunkPlan, n: int, m: int, device_index: int) -> int:
    """How many of ``plan``'s clusters (a cluster or split plan) at (n, m)
    the card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    lib = _libraries(device_index)[plan.variant]
    with torch.cuda.device(device_index):
        err = getattr(lib, f"admm_chunk_{plan.variant}_max_active")(
            n, m, *_layout_args(plan), int(plan.box), ctypes.byref(count)
        )
    if err != 0:
        raise RuntimeError(f"{plan.variant} occupancy query failed: CUDA error {err}")
    return count.value


def _check(W, A, c0, rho, l, u, x, z, y, n_iters, active, g=None, sigma=None):
    """(B, n, m) of a chunk's inputs; raises on what no kernel takes. With
    ``g`` (the box block) W is (B, n, n + m_d), A (B, m_d, n) and the
    vectors have m = m_d + n rows."""
    if W.dim() != 3:
        raise ValueError(f"W must be (B, n, n+m), got {tuple(W.shape)}")
    B, n, k = W.shape
    m_d = k - n
    m = m_d + (n if g is not None else 0)
    if (g is None) != (sigma is None):
        raise ValueError("the box block needs both g and sigma")
    if sigma is not None and not sigma > 0.0:
        raise ValueError(f"sigma must be > 0, got {sigma}")
    expected = {
        "W": (W, (B, n, n + m_d)),
        "A": (A, (B, m_d, n)),
        "c0": (c0, (B, n)),
        "rho": (rho, (B, m)),
        "l": (l, (B, m)),
        "u": (u, (B, m)),
        "x": (x, (B, n)),
        "z": (z, (B, m)),
        "y": (y, (B, m)),
    }
    if g is not None:
        expected["g"] = (g, (B, n))
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


def _launch(
    plan: ChunkPlan, W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None, g=None, sigma=None
):
    """Launch ``plan``'s kernel on checked CUDA tensors and count it in
    ``admm_chunk.launches`` (under a capture, at each replay that runs
    it: ``graph_loop.count_launch``); returns new (x, z, y). Raises where the
    plan does not take the operator's form (the box block or dense), or
    where the card cannot schedule the cluster or refuses the launch."""
    B, n = x.shape
    m = z.shape[1]
    if plan.box != (g is not None):
        raise ValueError(
            f"a {kernel_name(plan, False)} plan does not take a "
            f"{'box-block' if g is not None else 'dense'} operator"
        )
    x_out = torch.empty_like(x)
    z_out = torch.empty_like(z)
    y_out = torch.empty_like(y)
    if B == 0:
        return x_out, z_out, y_out
    index = W.device.index
    lib = _libraries(index)[plan.variant]
    if max_active_clusters(plan, n, m, index) == 0:
        raise RuntimeError(
            f"the card cannot schedule a cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} bytes of shared memory each"
        )
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = getattr(lib, f"admm_chunk_{plan.variant}_launch")(
            W.data_ptr(), A.data_ptr(), c0.data_ptr(), None if g is None else g.data_ptr(),
            rho.data_ptr(), l.data_ptr(), u.data_ptr(), x.data_ptr(), z.data_ptr(),
            y.data_ptr(), None if active is None else active.data_ptr(),
            x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
            B, n, m, *_layout_args(plan), int(n_iters), float(alpha), float(1.0 - alpha),
            float(sigma or 0.0), stream,
        )
    name = kernel_name(plan, active is not None)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(admm_chunk.launches, name)
    return x_out, z_out, y_out


def admm_chunk(W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active=None, g=None, sigma=None):
    """Run ``n_iters`` fused ADMM iterations for every scenario; returns
    new (x, z, y). With ``g`` (B, n) and ``sigma`` the operator comes with
    the box block (the module's docstring). CUDA tensors go to the kernel
    that :func:`plan_chunk` picks (or the call raises); CPU tensors go to
    :func:`admm_chunk_reference` or :func:`admm_chunk_box_reference`.
    ``admm_chunk.launches`` counts kernel launches by the names in
    ``KERNEL_NAMES``."""
    B, n, m = _check(W, A, c0, rho, l, u, x, z, y, n_iters, active, g, sigma)
    if W.device.type == "cpu":
        if g is not None:
            return admm_chunk_box_reference(
                W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active, g=g, sigma=sigma
            )
        return admm_chunk_reference(
            W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active
        )
    if W.device.type != "cuda":
        raise ValueError(f"admm_chunk runs on cuda or cpu, not {W.device}")
    n_b = n if g is not None else 0
    return _launch(
        plan_chunk(n, m, B, n_b), W, A, c0, rho, l, u, x, z, y, n_iters, alpha, active, g, sigma
    )


admm_chunk.launches = collections.Counter()
