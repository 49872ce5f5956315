"""The ADMM engines: the port's solve_box_qp and solve_box_qp_batched
against the JAX package on the cases of tests/test_admm.py and
tests/test_batched_qp.py (CPU; the JAX batched engine runs its Pallas
kernel in interpret mode)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.qp.admm import ADMMConfig as JConfig
from acmpc_tpu.qp.admm import solve_box_qp as jax_solve
from acmpc_tpu.qp.batched import solve_box_qp_batched as jax_solve_batched
from acmpc_tpu_torch.convert import qp_from_numpy
from acmpc_tpu_torch.qp.admm import ADMMConfig, solve_box_qp
from acmpc_tpu_torch.qp.batched import solve_box_qp_batched
from test_admm import _check_kkt, _equality_qp_reference, _random_qp

# The two engines' fp32 KKT inverses (LAPACK through XLA vs through
# torch) differ in rounding. ADMM carries that difference along its
# iterations, and both stop at a 1e-3 residual tolerance, which pins the
# solution of these problems only to about 1e-2: the engines are
# compared at 2e-2 (tests/test_batched_qp.py compares its two engines
# at 1e-2), and each converged solution is checked by KKT.
X_TOL = dict(rtol=2e-2, atol=2e-2)
# the batched engines run fixed rho (as test_batched_qp.py)
BATCH_KW = dict(adaptive_rho=False, rho=0.01, max_iter=20000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(*arrays):
    return [np.asarray(a) for a in arrays]


def _solve_both(qp, jcfg=JConfig(), tcfg=ADMMConfig()):
    ref = jax.jit(lambda *a: jax_solve(*a, jcfg))(*qp)
    ours = solve_box_qp(*qp_from_numpy(*_np(*qp), device="cpu"), tcfg)
    return ours, ref


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_box_qp_matches_jax(seed):
    qp = _random_qp(np.random.default_rng(seed), 30, 45, eq_rows=5, loose_rows=5)
    ours, ref = _solve_both(qp)
    assert int(ours.status) == int(ref.status) == 1
    _check_kkt(*qp, ours)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), **X_TOL)


def test_equality_closed_form():
    P, q, A, l, u = _random_qp(np.random.default_rng(0), 20, 8, eq_rows=8)
    ours, ref = _solve_both((P, q, A, l, u))
    assert int(ours.status) == int(ref.status) == 1
    expected = _equality_qp_reference(P, q, A, np.asarray(l))
    np.testing.assert_allclose(ours.x.numpy(), expected, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), **X_TOL)


def test_max_iter_reported():
    qp = _random_qp(np.random.default_rng(5), 30, 40)
    kw = dict(max_iter=25, check_every=25, eps_abs=1e-9, eps_rel=1e-9)
    ours, ref = _solve_both(qp, JConfig(**kw), ADMMConfig(**kw))
    assert int(ours.status) == int(ref.status) == 0
    assert int(ours.iterations) == int(ref.iterations) == 25
    # one chunk of identical arithmetic: rounding-level agreement
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)


def test_primal_infeasibility_certificate():
    rng = np.random.default_rng(3)
    n = 12
    Mx = rng.normal(size=(n, n))
    P = (Mx @ Mx.T + np.eye(n)).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    A = np.vstack([np.eye(n)[:1], np.eye(n)[:1], np.eye(n)]).astype(np.float32)
    l = np.full(n + 2, -10.0, np.float32)
    u = np.full(n + 2, 10.0, np.float32)
    l[0] = u[0] = 0.0
    l[1] = u[1] = 5.0  # x0 == 0 and x0 == 5
    ours, ref = _solve_both(tuple(jnp.asarray(v) for v in (P, q, A, l, u)))
    assert int(ours.status) == int(ref.status) == 2
    assert int(ours.iterations) < 1000
    assert abs(int(ours.iterations) - int(ref.iterations)) <= 25


def test_rti_fixed_iterations_single():
    qp = _random_qp(np.random.default_rng(4), 20, 30, eq_rows=3)
    kw = dict(fixed_iterations=100, adaptive_rho=False)
    ours, ref = _solve_both(qp, JConfig(**kw), ADMMConfig(**kw))
    assert int(ours.iterations) == int(ref.iterations) == 100
    assert int(ours.status) == int(ref.status)
    # the same 100 iterations on operators that differ by their rounding
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), **X_TOL)


def _batch(seeds, n=20, m=30):
    qps = [_random_qp(np.random.default_rng(s), n, m, eq_rows=4) for s in seeds]
    stacked = [np.stack([np.asarray(qp[i]) for qp in qps]) for i in range(5)]
    return qps, stacked


def test_batched_matches_jax_and_tile_skip_is_exact():
    qps, stacked = _batch(range(8))
    jcfg, tcfg = JConfig(**BATCH_KW), ADMMConfig(**BATCH_KW)
    ref = jax.jit(lambda *a: jax_solve_batched(*a, jcfg))(*(jnp.asarray(v) for v in stacked))
    tq = qp_from_numpy(*stacked, device="cpu")
    base = solve_box_qp_batched(*tq, tcfg)
    skip = solve_box_qp_batched(*tq, dataclasses.replace(tcfg, tile_skip=True))
    np.testing.assert_array_equal(base.status.numpy(), np.asarray(ref.status))
    assert (base.status.numpy() == 1).all()
    np.testing.assert_allclose(base.x.numpy(), np.asarray(ref.x), **X_TOL)
    assert (np.abs(base.iterations.numpy() - np.asarray(ref.iterations)) <= 25).all()
    for i, qp in enumerate(qps):
        _check_kkt(*qp, types.SimpleNamespace(x=base.x[i], y=base.y[i]))
    # skipping converged scenarios changes nothing: frozen lanes keep
    # their iterates either way
    np.testing.assert_array_equal(base.status.numpy(), skip.status.numpy())
    np.testing.assert_array_equal(base.iterations.numpy(), skip.iterations.numpy())
    np.testing.assert_array_equal(base.x.numpy(), skip.x.numpy())


def test_batched_rti_path_matches_jax():
    _, stacked = _batch(range(4))
    kw = dict(BATCH_KW, fixed_iterations=150)
    ref = jax.jit(lambda *a: jax_solve_batched(*a, JConfig(**kw)))(
        *(jnp.asarray(v) for v in stacked)
    )
    ours = solve_box_qp_batched(*qp_from_numpy(*stacked, device="cpu"), ADMMConfig(**kw))
    assert (ours.iterations.numpy() == 150).all()
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), **X_TOL)


def test_batched_refuses_adaptive_rho():
    _, stacked = _batch(range(2))
    with pytest.raises(ValueError):
        solve_box_qp_batched(*qp_from_numpy(*stacked, device="cpu"), ADMMConfig())


def test_batched_member_equals_single_solve():
    # fixed rho on both: the batched engine and the single-scenario
    # engine run the same iterations on each scenario
    qps, stacked = _batch(range(3))
    tcfg = ADMMConfig(**BATCH_KW)
    batched = solve_box_qp_batched(*qp_from_numpy(*stacked, device="cpu"), tcfg)
    for i, qp in enumerate(qps):
        single = solve_box_qp(*qp_from_numpy(*_np(*qp), device="cpu"), tcfg)
        assert int(single.status) == int(batched.status[i])
        assert int(single.iterations) == int(batched.iterations[i])
        torch.testing.assert_close(single.x, batched.x[i], rtol=1e-4, atol=1e-4)
