"""Ruiz equilibration (``ops/ruiz.py``) on the CPU: the wrapper's plain
path, its plans and its checks, and a model of the kernel's order of
operations. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import acmpc_tpu_torch.qp.admm as tadmm
from acmpc_tpu_torch.ops.ruiz import (
    KERNEL_NAMES,
    MAX_CLUSTER,
    MAX_SCALING,
    MIN_SCALING,
    SMEM_PER_BLOCK,
    _check,
    plan_ruiz,
    ruiz_equilibrate,
    ruiz_equilibrate_reference,
    smem_bytes,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors: one intra-op thread per test worker
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qps(batch, n, m, seed, box=False):
    """B QPs (P, q, A) in float32 with entries over several decades, as the
    MPC's are; with ``box`` A ends in the identity over the variables."""
    rng = np.random.default_rng(seed)
    Mx = rng.normal(size=(batch, n, n)) * 10.0 ** rng.uniform(-2, 2, size=(batch, 1, n))
    P = Mx @ Mx.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    q = rng.normal(size=(batch, n)) * 10.0 ** rng.uniform(-3, 3, size=(batch, n))
    A = rng.normal(size=(batch, m, n)) * 10.0 ** rng.uniform(-2, 2, size=(batch, m, 1))
    if box:
        A[:, m - n:] = np.eye(n)
    return tuple(torch.as_tensor(a, dtype=torch.float32) for a in (P, q, A))


# (n, m) of the main path's QPs and the raceline's: the plan and its
# cluster size. The vectors add a CTA at horizon 100 and two at 586
# points to the slabs' 3, 12 and 12
PLANS = {
    "h50": ((248, 398), "resident", 3),
    "h100": ((498, 798), "resident", 13),
    "raceline_586": ((586, 586), "resident", 14),
    "raceline_1953": ((1953, 1953), "streamed", 16),
}


@pytest.mark.parametrize("shape", list(PLANS))
@pytest.mark.parametrize("batch", [1, 32, 256])
def test_plan_ruiz_at_the_main_path_shapes(shape, batch):
    (n, m), variant, C = PLANS[shape]
    plan = plan_ruiz(n, m, batch)
    assert (plan.variant, plan.cluster) == (variant, C)
    assert plan.smem_bytes == smem_bytes(n, m, C, variant == "resident") <= SMEM_PER_BLOCK
    if variant == "resident":
        # the fewest CTAs that hold the lane
        assert C == 1 or smem_bytes(n, m, C - 1, True) > SMEM_PER_BLOCK
    else:
        assert smem_bytes(n, m, MAX_CLUSTER, True) > SMEM_PER_BLOCK


@pytest.mark.parametrize("n_iters", [0, 1, 5, 10])
@pytest.mark.parametrize("batch", [None, 1, 4])
def test_cpu_path_is_the_plain_version_bit_for_bit(n_iters, batch):
    P, q, A = _qps(batch or 1, 24, 40, seed=n_iters, box=True)
    if batch is None:
        P, q, A = P[0], q[0], A[0]
    launches = dict(ruiz_equilibrate.launches)
    got = ruiz_equilibrate(P, q, A, n_iters)
    want = tadmm._ruiz_equilibrate(P, q, A, n_iters)
    assert dict(ruiz_equilibrate.launches) == launches
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def test_solver_name_is_the_plain_version():
    # qp/admm.py keeps the JAX package's name for the plain version
    assert tadmm._ruiz_equilibrate is ruiz_equilibrate_reference
    assert tadmm.ruiz_equilibrate is ruiz_equilibrate


def test_no_silent_fallback_off_cpu():
    P, q, A = _qps(2, 8, 12, seed=3)
    with pytest.raises(ValueError):
        ruiz_equilibrate(P.to("meta"), q.to("meta"), A.to("meta"), 5)


@pytest.mark.parametrize(
    "fault, error",
    [
        ("dtype", TypeError),
        ("contiguity", ValueError),
        ("shape_P", ValueError),
        ("shape_A", ValueError),
        ("rank", ValueError),
        ("device", ValueError),
        ("n_iters", ValueError),
    ],
)
def test_kernel_checks_refuse_what_it_does_not_take(fault, error):
    P, q, A = _qps(3, 8, 12, seed=4)
    n_iters = 5
    if fault == "dtype":
        P = P.double()
    elif fault == "contiguity":
        A = A.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "shape_P":
        P = P[:, :, :7].contiguous()
    elif fault == "shape_A":
        A = A[:2]
    elif fault == "rank":
        P = P[0]
    elif fault == "device":
        A = A.to("meta")
    else:
        n_iters = -1
    with pytest.raises(error):
        _check(P, q, A, n_iters)


def test_checks_take_one_qp_and_lanes():
    P, q, A = _qps(3, 8, 12, seed=5)
    assert _check(P, q, A, 10) == (3, 8, 12)
    assert _check(P[0], q[0], A[0], 0) == (1, 8, 12)
    assert KERNEL_NAMES == ("ruiz_equilibrate[resident]", "ruiz_equilibrate[streamed]")


def test_scaling_by_a_positive_factor_commutes_with_the_max_in_fp32():
    # the kernel takes the next pass's column maxima of P g as
    # fl(g colmax|P|): rounding is monotonic, so for g > 0 the largest
    # |fl(g x)| is fl(g max|x|) bit for bit (subnormals included)
    rng = np.random.default_rng(7)
    for trial in range(400):
        x = rng.normal(size=(64, 37)) * 10.0 ** rng.uniform(-44, 30, size=(1, 37))
        x = torch.as_tensor(x, dtype=torch.float32)
        g = torch.tensor(10.0 ** rng.uniform(-4, 4), dtype=torch.float32)
        left = torch.amax(torch.abs(x * g), dim=0)
        right = g * torch.amax(torch.abs(x), dim=0)
        assert torch.equal(left, right), trial


def _clamp(t):
    return torch.clamp(t, MIN_SCALING, MAX_SCALING)


def _kernel_order(P, q, A, n_iters):
    """The kernel's order of operations, one lane in float32: the column
    maxima of P g as fl(g colmax|P|), g applied to P by the next pass's
    sweep with its dd (rounded after each product), the last g as P_s is
    written out; the mean as torch takes it."""
    n = q.shape[-1]
    d, e, c = torch.ones(n), torch.ones(A.shape[0]), torch.tensor(1.0)
    g = torch.tensor(1.0)
    col_p = torch.amax(torch.abs(P), dim=0)
    col_a = torch.amax(torch.abs(A), dim=0)
    row_a = torch.amax(torch.abs(A), dim=1)
    for _ in range(n_iters):
        dd = 1.0 / torch.sqrt(_clamp(torch.maximum(g * col_p, col_a)))
        ee = 1.0 / torch.sqrt(_clamp(row_a))
        q, d, e = q * dd, d * dd, e * ee
        P = P * g * dd[:, None] * dd[None, :]
        A = A * ee[:, None] * dd[None, :]
        col_p = torch.amax(torch.abs(P), dim=0)
        col_a = torch.amax(torch.abs(A), dim=0)
        row_a = torch.amax(torch.abs(A), dim=1)
        g = 1.0 / _clamp(torch.maximum(torch.mean(col_p), torch.amax(torch.abs(q))))
        q, c = q * g, c * g
    return P * g, q, A, c, d, e


@pytest.mark.parametrize("n_iters", [0, 1, 2, 5, 10])
@pytest.mark.parametrize("shape", [(24, 40, True), (13, 5, False), (31, 31, True)])
def test_kernel_order_of_operations_equals_the_plain_version(n_iters, shape):
    n, m, box = shape
    P, q, A = _qps(3, n, m, seed=11 + n_iters, box=box)
    for b in range(3):
        got = _kernel_order(P[b], q[b], A[b], n_iters)
        want = ruiz_equilibrate_reference(P[b], q[b], A[b], n_iters)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _outputs(*values):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in values)


@pytest.mark.parametrize(
    "got, want, err",
    [
        (([1.0, 0.0], [2.0]), ([1.0, 0.0], [2.0]), 0.0),
        (([1.0, -3.0], [2.0]), ([1.0, -2.0], [2.0]), 0.5),
        (([1.0, 1e-30], [2.0]), ([1.0, 0.0], [2.0]), float("inf")),
        (([1.0, float("nan")], [2.0]), ([1.0, 1.0], [2.0]), float("inf")),
    ],
    ids=["equal", "relative", "zero_differs", "nan"],
)
def test_the_card_checks_relative_error_over_every_output(got, want, err):
    """chip_smoke.py's phase 3 holds the kernel to the plain version by
    ``rel_err`` over all six outputs: the largest relative difference,
    inf where a zero or a non-finite value differs."""
    from chip_smoke import rel_err

    assert rel_err(_outputs(*got), _outputs(*want)) == err


def test_the_card_bound_is_the_matrices_read_and_written_once():
    from chip_smoke import ruiz_bound_ms

    # horizon 50 at B = 256: 328 MB at 3.35 TB/s
    assert ruiz_bound_ms(248, 398, 256) == pytest.approx(0.0984, abs=1e-4)
    assert ruiz_bound_ms(248, 398, 512) == pytest.approx(2 * ruiz_bound_ms(248, 398, 256))
