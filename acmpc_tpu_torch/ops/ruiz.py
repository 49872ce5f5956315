"""Ruiz equilibration of QPs: the CUDA kernel, its plain version and the
wrapper that picks between them.

Modified Ruiz equilibration of the KKT matrix [[P, A'], [A, 0]] plus
OSQP's cost normalisation (``acmpc_tpu/qp/admm.py::_ruiz_equilibrate``,
which the JAX package leaves to XLA): ``n_iters`` passes that scale the
columns by dd = 1 / sqrt(max(colmax|P|, colmax|A|)) and A's rows by
ee = 1 / sqrt(rowmax|A|), then the cost by g = 1 / max(mean colmax|P|,
max|q|), each norm clamped to [1e-4, 1e4]. Returns (P_s, q_s, A_s, c, d,
e): P_s = c D P D, q_s = c D q, A_s = E A D.

CPU tensors go to :func:`ruiz_equilibrate_reference`; CUDA tensors go to
``csrc/ruiz_equilibrate.cu`` (one launch for all lanes and all passes,
a thread-block cluster a lane), on the plan :func:`plan_ruiz` picks, and
a refused launch raises. ``ruiz_equilibrate.launches`` counts the
launches by plan variant (``ruiz_equilibrate[resident]``,
``ruiz_equilibrate[streamed]``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

SOURCE = "ruiz_equilibrate.cu"
RESIDENT = "ruiz_equilibrate[resident]"
STREAMED = "ruiz_equilibrate[streamed]"
KERNEL_NAMES = (RESIDENT, STREAMED)

MIN_SCALING = 1e-4
MAX_SCALING = 1e4

# H100: shared memory one block may use, and the largest cluster (above
# 8 CTAs only with the non-portable opt-in)
SMEM_PER_BLOCK = 232_448
MAX_CLUSTER = 16
# warps of a CTA (csrc/admm_chunk_common.cuh's kThreads / 32)
WARPS = 16


def _inf_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=dim)


def ruiz_equilibrate_reference(P, q, A, n_iters):
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
        dd = 1.0 / torch.sqrt(torch.clamp(col_norm, MIN_SCALING, MAX_SCALING))
        ee = 1.0 / torch.sqrt(torch.clamp(row_norm, MIN_SCALING, MAX_SCALING))
        P = P * dd[..., :, None] * dd[..., None, :]
        q = q * dd
        A = A * ee[..., :, None] * dd[..., None, :]
        d = d * dd
        e = e * ee
        # cost normalisation (OSQP sec. 5.1)
        p_cols = torch.mean(_inf_norm(P, dim=-2), dim=-1)
        g = 1.0 / torch.clamp(
            torch.maximum(p_cols, _inf_norm(q)), MIN_SCALING, MAX_SCALING
        )
        P = P * g[..., None, None]
        q = q * g[..., None]
        c = c * g
    return P, q, A, c, d, e


def _round4(v: int) -> int:
    return (v + 3) & ~3


def smem_bytes(n: int, m: int, C: int, resident: bool) -> int:
    """Dynamic shared memory of one CTA of a cluster of C CTAs a lane (the
    layout of ``csrc/ruiz_equilibrate.cu``): two mbarriers (16 bytes);
    where ``resident``, the CTA's slabs of P's and A's rows, each with 3
    floats of room for its alignment shift and rounded to 4 floats; dd,
    the reduced column maxima of A, q, d and two buffers of the CTA's
    column maxima of P and of A (8 n); row maxima, ee and e of its A rows;
    2 x 16 floats of scratch."""
    rows_p, rows_a = -(-n // C), -(-m // C)
    slabs = _round4(rows_p * n + 3) + _round4(rows_a * n + 3) if resident else 0
    return 16 + 4 * (slabs + 8 * n + 3 * rows_a + 2 * WARPS)


@dataclasses.dataclass(frozen=True)
class RuizPlan:
    variant: str  # "resident" or "streamed"
    cluster: int  # CTAs a lane
    smem_bytes: int  # dynamic shared memory a CTA


def ruiz_plan(n: int, m: int, C: int, resident: bool) -> RuizPlan:
    return RuizPlan("resident" if resident else "streamed", C, smem_bytes(n, m, C, resident))


def plan_ruiz(n: int, m: int, B: int) -> RuizPlan:
    """Which plan equilibrates B lanes of P (n, n) and A (m, n), from the
    shapes alone. Resident where a cluster of at most 16 CTAs holds the
    lane's P and A in shared memory, with the fewest CTAs that do
    (horizon 50: 3; horizon 100: 13; the 586-point raceline: 14, the
    per-lane vectors costing one and two CTAs above the slabs' own 12), so
    that the card holds the most lanes at once (39 clusters of 3, 30 of
    4, 22 of 5, 7 of any size from 10). Else streamed, with 16 CTAs (the
    1,953-point raceline). Measured on an H100 at the MPC's 5 passes,
    every cluster size against the plain version, horizon 50: at B = 256, C = 3 0.378 ms, 4
    0.398, 5 0.472, 6 0.570, 8 0.621, 10-16 1.23-1.41 (streamed at 8 and
    16: 1.51, 2.40); at B = 32, C = 3 0.081 ms, 4-6 0.083-0.090, 8 0.113,
    10-16 0.173-0.199; at B = 1, where one lane's chain of passes is all
    there is, C = 5 0.050 ms against 0.058 at 3 (4-16: 0.050-0.066), an
    8 us the rule leaves. Horizon 100: C = 13, 14 and 16 within 3% of
    one another at B = 1, 8 and 32 (0.078, 0.155, 0.391 ms at 13); 586
    points: 14 and 16 within 2%."""
    for C in range(1, MAX_CLUSTER + 1):
        if smem_bytes(n, m, C, True) <= SMEM_PER_BLOCK:
            return ruiz_plan(n, m, C, True)
    plan = ruiz_plan(n, m, MAX_CLUSTER, False)
    if plan.smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(f"no Ruiz plan takes n={n}, m={m}: the vectors do not fit")
    return plan


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The kernel's library for one card."""
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.ruiz_equilibrate_launch.argtypes = (
        [_PTR] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [_PTR]
    )
    lib.ruiz_equilibrate_launch.restype = ctypes.c_int
    lib.ruiz_equilibrate_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ruiz_equilibrate_smem_bytes.restype = ctypes.c_longlong
    lib.ruiz_equilibrate_max_active.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.ruiz_equilibrate_max_active.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_active_clusters(plan: RuizPlan, n: int, m: int, device_index: int) -> int:
    """How many of ``plan``'s clusters at (n, m) the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library(device_index).ruiz_equilibrate_max_active(
            n, m, plan.cluster, int(plan.variant == "resident"), ctypes.byref(count)
        )
    if err != 0:
        raise RuntimeError(f"Ruiz occupancy query failed: CUDA error {err}")
    return count.value


def kernel_name(plan: RuizPlan) -> str:
    """The launch counter of ``plan``'s kernel: ``KERNEL_NAMES``."""
    return f"ruiz_equilibrate[{plan.variant}]"


def _check(P, q, A, n_iters):
    """(B, n, m) of one QP (q (n,)) or of B lanes (q (B, n)); raises on
    what the kernel does not take."""
    lead = q.shape[:-1]
    if q.dim() not in (1, 2) or P.dim() != q.dim() + 1 or A.dim() != q.dim() + 1:
        raise ValueError(
            f"P, q, A must be (n, n), (n,), (m, n) or carry one lane axis, got "
            f"{tuple(P.shape)}, {tuple(q.shape)}, {tuple(A.shape)}"
        )
    n = q.shape[-1]
    m = A.shape[-2]
    for name, t, shape in (("P", P, (*lead, n, n)), ("A", A, (*lead, m, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("P", P), ("q", q), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1:
        raise ValueError("a QP needs at least one variable")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    return (int(lead[0]) if lead else 1), n, m


def _launch(plan: RuizPlan, P, q, A, n_iters):
    """Launch ``plan``'s kernel on checked CUDA tensors of B lanes (P (B, n,
    n), q (B, n), A (B, m, n)) and count it in ``ruiz_equilibrate.launches``
    (under a capture, at each replay: ``graph_loop.count_launch``); returns
    (P_s, q_s, A_s, c, d, e). Raises where the card cannot schedule the
    cluster or refuses the launch."""
    B, n = q.shape
    m = A.shape[1]
    Ps, qs, As = torch.empty_like(P), torch.empty_like(q), torch.empty_like(A)
    c = torch.empty(B, dtype=q.dtype, device=q.device)
    d = torch.empty_like(q)
    e = torch.empty((B, m), dtype=q.dtype, device=q.device)
    if B == 0:
        return Ps, qs, As, c, d, e
    index = q.device.index
    if max_active_clusters(plan, n, m, index) == 0:
        raise RuntimeError(
            f"the card cannot schedule a cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} bytes of shared memory each"
        )
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library(index).ruiz_equilibrate_launch(
            P.data_ptr(), q.data_ptr(), A.data_ptr(), Ps.data_ptr(), qs.data_ptr(),
            As.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(),
            B, n, m, plan.cluster, int(plan.variant == "resident"), int(n_iters),
            MIN_SCALING, MAX_SCALING, stream,
        )
    name = kernel_name(plan)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(ruiz_equilibrate.launches, name)
    return Ps, qs, As, c, d, e


def ruiz_equilibrate(P, q, A, n_iters):
    """Ruiz equilibration of one QP (P (n, n), q (n,), A (m, n)) or of B
    lanes along a leading axis, each lane scaled alone; returns (P_s, q_s,
    A_s, c, d, e) as :func:`ruiz_equilibrate_reference` does. CPU tensors
    go to that plain version; CUDA tensors (fp32, contiguous) to the
    kernel on the plan :func:`plan_ruiz` picks, or the call raises."""
    if all(t.device.type == "cpu" for t in (P, q, A)):
        return ruiz_equilibrate_reference(P, q, A, n_iters)
    B, n, m = _check(P, q, A, n_iters)
    if q.device.type != "cuda":
        raise ValueError(f"ruiz_equilibrate runs on cuda or cpu, not {q.device}")
    if q.dim() == 1:
        out = _launch(plan_ruiz(n, m, 1), P[None], q[None], A[None], n_iters)
        return tuple(t[0] for t in out)
    return _launch(plan_ruiz(n, m, B), P, q, A, n_iters)


ruiz_equilibrate.launches = collections.Counter()
