"""The port's linear-algebra ops of the speed profile and the SPD inverse
against the JAX package's (CPU): ``ops/tridiag.py`` (product, PCR solve),
``ops/spd_inverse.py``, and ``qp/speed_profile.solve_speed_profile_admm``
(the ADMM cross-check that solves through PCR).

Tolerances, each beside its check:
* PCR: tests/test_tridiag.py's 2e-4 / 2e-5 against a float64 dense solve,
  and 1e-5 relative against JAX's (the same elementwise fp32 steps in two
  libraries);
* the SPD inverse: the residual |I - K M| of tests/test_tridiag.py (1e-3)
  and of tests/test_batched_qp.py on the real horizon-50 KKT matrices
  (1e-3, and at most 10x the Cholesky route's); against JAX's inverse,
  1e-4 of its largest entry on random well-conditioned matrices, and the
  KKT matrices' condition (~1e4) times fp32 rounding on those;
* the ADMM profile: tests/test_speed_profile.py's 5e-3 / 2e-2 against the
  exact scan, the same iteration count as JAX's and 1e-3 / 2e-3 against
  its velocities.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.geometry.path import construct_waypoints as jconstruct
from acmpc_tpu.geometry.tracks import get_hairpin_track, with_widths
from acmpc_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from acmpc_tpu.ops.tridiag import tridiag_matvec as j_matvec, tridiag_solve as j_solve
from acmpc_tpu.qp.speed_profile import (
    SpeedProfileConstraints as JConstraints,
    solve_speed_profile_admm as j_admm,
)
from acmpc_tpu_torch.geometry.path import construct_waypoints
from acmpc_tpu_torch.ops import spd_inverse, tridiag_matvec, tridiag_solve
from acmpc_tpu_torch.qp.admm import _factor
from acmpc_tpu_torch.qp.speed_profile import (
    SpeedProfileConstraints,
    solve_speed_profile,
    solve_speed_profile_admm,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_tridiag import _dense, _random_dd_system  # noqa: E402

CONS = dict(v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 49, 128, 1000, 4097])
def test_tridiag_solve_matches_dense_and_jax(n):
    rng = np.random.default_rng(n)
    system = tuple(a.astype(np.float32) for a in _random_dd_system(rng, n))
    got = tridiag_solve(*_t(*system)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(_dense(*system[:3]), system[3]), rtol=2e-4, atol=2e-5)
    want = np.asarray(j_solve(*(jnp.asarray(a) for a in system)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tridiag_matvec_matches_dense_and_jax():
    rng = np.random.default_rng(0)
    sub, diag, sup, _ = (a.astype(np.float32) for a in _random_dd_system(rng, 33))
    x = rng.uniform(-1, 1, 33).astype(np.float32)
    got = tridiag_matvec(*_t(sub, diag, sup, x)).numpy()
    np.testing.assert_allclose(got, _dense(sub, diag, sup) @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(j_matvec(*(jnp.asarray(a) for a in (sub, diag, sup, x)))))


def test_tridiag_solve_batched():
    rng = np.random.default_rng(7)
    systems = [tuple(a.astype(np.float32) for a in _random_dd_system(rng, 65)) for _ in range(16)]
    stacked = [np.stack([s[i] for s in systems]) for i in range(4)]
    got = tridiag_solve(*_t(*stacked)).numpy()
    for i, (a, b, c, d) in enumerate(systems):
        np.testing.assert_allclose(got[i], np.linalg.solve(_dense(a, b, c), d), rtol=2e-4, atol=2e-5)
    want = np.asarray(jax.jit(j_solve)(*(jnp.asarray(a) for a in stacked)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n, batch", [(2, ()), (7, ()), (37, (3,)), (248, (2,))])
def test_spd_inverse_matches_jax(n, batch):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(*batch, n, n)).astype(np.float32)
    K = M @ np.swapaxes(M, -1, -2) + n * np.eye(n, dtype=np.float32)
    got = spd_inverse(torch.as_tensor(K)).numpy()
    assert np.abs(np.eye(n) - K @ got).max() < 1e-3
    want = np.asarray(j_spd_inverse(jnp.asarray(K)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def real_kkt():
    """tests/test_batched_qp.py's real horizon-50 control-QP KKT matrices
    (monza racing, 4 curved windows), built through the JAX package:
    (K, Ruiz-scaled P, A, rho) as numpy."""
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge
    from acmpc_tpu.qp.admm import _rho_vector, _ruiz_equilibrate

    H, B = 50, 4
    mpc = ge._make_mpc(H)
    refs = ge._reference_window(H, B)
    states = jax.vmap(lambda: mpc.initial_state(), axis_size=B)()
    v_max = jnp.full((B,), mpc.config.constraints.v_max, mpc.dtype)
    is_loc, offs = jnp.zeros((B,), bool), jnp.zeros((B,), mpc.dtype)
    _, _, (P, q, A, l, u) = jax.jit(
        lambda s: jax.vmap(mpc._prepare)(s, refs, v_max, is_loc, offs)
    )(states)
    with jax.default_matmul_precision("highest"):
        Ps, _, As, _, _, e = jax.vmap(lambda P_, q_, A_: _ruiz_equilibrate(P_, q_, A_, 5))(P, q, A)
        rv = jax.vmap(lambda lo, hi: _rho_vector(jnp.asarray(0.1, jnp.float32), lo, hi))(e * l, e * u)
        n = P.shape[-1]
        K = Ps + 1e-5 * jnp.eye(n) + jnp.einsum("bmn,bm,bmk->bnk", As, rv, As)
        M_jax = j_spd_inverse(K)
    return tuple(np.array(a) for a in (K, Ps, As, rv, M_jax))


def test_spd_inverse_on_real_mpc_kkt(real_kkt):
    """On the real horizon-50 KKT matrices: as accurate as
    tests/test_batched_qp.py asks of JAX's, against the port's Cholesky
    route (``_factor``) on the same matrices, and close to JAX's."""
    K, Ps, As, rv, M_jax = real_kkt
    n = K.shape[-1]
    M = spd_inverse(torch.as_tensor(K)).numpy()
    M_chol = _factor(*_t(Ps, As, rv), 1e-5).numpy()
    eye = np.eye(n)
    r_blocked = np.abs(eye - K.astype(np.float64) @ M).max(axis=(1, 2))
    r_chol = np.abs(eye - K.astype(np.float64) @ M_chol).max(axis=(1, 2))
    assert r_blocked.max() < 1e-3, r_blocked
    assert (r_blocked <= 10 * np.maximum(r_chol, 1e-6)).all(), (r_blocked, r_chol)
    # fp32 rounding (6e-8) amplified by the condition (~1e4)
    np.testing.assert_allclose(M, M_jax, rtol=0, atol=1e-3 * np.abs(M_jax).max())


@pytest.mark.parametrize("radius, n", [(25.0, 40), (60.0, 80)])
def test_admm_profile_matches_scan_and_jax(radius, n):
    """tests/test_speed_profile.py::test_scan_matches_admm's hairpins."""
    coords = with_widths(get_hairpin_track(radius, n)).astype(np.float32)
    path = construct_waypoints(torch.as_tensor(coords))
    cons = SpeedProfileConstraints(**CONS)
    exact = solve_speed_profile(path.distances, path.kappas, cons)
    admm = solve_speed_profile_admm(path.distances, path.kappas, cons)
    assert int(exact.status) == 1 and int(admm.status) == 1
    np.testing.assert_allclose(admm.velocities.numpy(), exact.velocities.numpy(), rtol=5e-3, atol=2e-2)
    jpath = jconstruct(jnp.asarray(coords))
    want = jax.jit(lambda d, k: j_admm(d, k, JConstraints(**CONS)))(jpath.distances, jpath.kappas)
    assert int(admm.iterations) == int(want.iterations)
    np.testing.assert_allclose(admm.velocities.numpy(), np.asarray(want.velocities), rtol=1e-3, atol=2e-3)


def test_admm_profile_options_match_jax():
    """Localised caps, no end-velocity pin, a warm start and fixed rho."""
    coords = with_widths(get_hairpin_track(30.0, 60)).astype(np.float32)
    path = construct_waypoints(torch.as_tensor(coords))
    jpath = jconstruct(jnp.asarray(coords))
    v0 = np.linspace(8.0, 20.0, path.n_points).astype(np.float32)
    from acmpc_tpu.qp.admm import ADMMConfig as JADMMConfig
    from acmpc_tpu_torch.qp.admm import ADMMConfig

    kw = dict(v_max_runtime=22.0, localised=True, use_end_velocity=False)
    got = solve_speed_profile_admm(
        path.distances, path.kappas, SpeedProfileConstraints(**CONS),
        cfg=dataclasses.replace(ADMMConfig(), adaptive_rho=False), v0=torch.as_tensor(v0), **kw,
    )
    want = j_admm(
        jpath.distances, jpath.kappas, JConstraints(**CONS),
        cfg=dataclasses.replace(JADMMConfig(), adaptive_rho=False), v0=jnp.asarray(v0), **kw,
    )
    assert int(got.status) == int(want.status) == 1
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities), rtol=1e-3, atol=2e-3)
    assert got.velocities.max() <= 22.0 + 2e-2
