"""The vmapped control step: ``solve_box_qp`` over a scenario axis,
``SpatialMPC.batched_get_control`` and ``LapSweep.run`` on it, against
the port's own single-scenario calls and against the JAX package's
``vmap`` of them (CPU).

Tolerances, each beside its check:
* lanes against single solves: 1e-6, with status, iterations and the rho
  each lane ends on equal. On the CPU the batched path computes every
  product lane by lane as the single solve does, so they agree bit for
  bit and the gate holds with room;
* against ``jax.vmap(solve_box_qp)``: X_TOL of tests/test_torch_admm.py
  (2e-2; the two packages' fp32 KKT inverses differ in rounding and both
  stop at a 1e-3 residual), with status equal;
* the control step against JAX's ``batched_get_control``: 5e-3 (the
  golden fixture's), ``solved`` equal; against the port's ``get_control``
  per lane: 2e-3, tests/test_mpc.py's own tolerance for its batched
  step;
* the closed loop: tests/test_torch_lap_sweep.py's LOOP_TOL, the JAX
  package's run-vs-fused tolerance.
"""

import dataclasses
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.dynamics import SpatialBicycleModel as JModel, VehicleParams as JVehicle
from acmpc_tpu.geometry.tracks import (
    get_chicane_track,
    get_hairpin_track,
    get_straight_track,
    with_widths,
)
from acmpc_tpu.mpc.spatial_mpc import MPCConfig as JConfig, SpatialMPC as JMPC
from acmpc_tpu.qp.admm import ADMMConfig as JADMMConfig, solve_box_qp as jax_solve
from acmpc_tpu.qp.speed_profile import SpeedProfileConstraints as JConstraints
from acmpc_tpu_torch.bench.lap_sweep import CarState, SweepGrid
from acmpc_tpu_torch.convert import sweep_grid_from_numpy
from acmpc_tpu_torch.dynamics import SpatialBicycleModel, VehicleParams
from acmpc_tpu_torch.mpc.spatial_mpc import (
    MPCConfig,
    SpatialMPC,
    shift_warm_start,
)
from acmpc_tpu_torch.qp.admm import (
    STATUS_PRIMAL_INFEASIBLE,
    STATUS_SOLVED,
    ADMMConfig,
    _scaled_problem,
    _solve_lanes,
    _solve_one,
    solve_box_qp,
)
from acmpc_tpu_torch.qp.speed_profile import SpeedProfileConstraints

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_lap_sweep import LOOP_TOL, _grid, _jgrid, pair  # noqa: E402,F401

LANE_TOL = 1e-6
X_TOL = dict(rtol=2e-2, atol=2e-2)
JAX_STEP_TOL = dict(rtol=5e-3, atol=5e-3)
SINGLE_STEP_TOL = dict(rtol=2e-3, atol=2e-3)
SOLUTION_FIELDS = ("x", "y", "z", "r_prim", "r_dual")
# tests/test_mpc.py's configuration and its four tracks
CONS = dict(v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0)
CONTROL = dict(horizon=30, step_cost=(4.0e-3, 5.0e-2, 0.0), r_term=(1.0e-2, 10.0), final_cost=(1.0, 0.0, 0.1))
CONFIGS = {
    "adaptive": dict(),
    "fixed_rho": dict(adaptive_rho=False, rho=0.01, max_iter=20000),
    "rti": dict(fixed_iterations=100, adaptive_rho=False),
    "budget": dict(max_iter=100),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_qp(rng, n, m, eq_rows=3, loose_rows=3):
    """tests/test_admm.py's random convex box QP, as numpy fp32."""
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    centre = A @ rng.normal(size=n)
    half = np.abs(rng.normal(size=m)) + 0.5
    l, u = centre - half, centre + half
    u[:eq_rows] = l[:eq_rows]
    l[m - loose_rows :], u[m - loose_rows :] = -np.inf, np.inf
    return [np.asarray(v, np.float32) for v in (P, q, A, l, u)]


def _infeasible_qp(rng, n, m):
    """Two copies of one row pinned to 0 and to 5."""
    P, q, A, l, u = _random_qp(rng, n, m, eq_rows=0, loose_rows=0)
    A[1] = A[0]
    l[0] = u[0] = 0.0
    l[1] = u[1] = 5.0
    return [P, q, A, l, u]


@pytest.fixture(scope="module")
def lanes():
    """Seven random QPs at n = 20, m = 30 and one infeasible one, stacked."""
    rng = np.random.default_rng(0)
    qps = [_random_qp(rng, 20, 30) for _ in range(7)] + [_infeasible_qp(rng, 20, 30)]
    return qps, [np.stack([qp[i] for qp in qps]) for i in range(5)]


def _torch(arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lanes_equal_single_solves(lanes, name):
    qps, stacked = lanes
    cfg = ADMMConfig(**CONFIGS[name])
    batch, rho = _solve_lanes(*_torch(stacked), cfg, None, None)
    for i, qp in enumerate(qps):
        one, one_rho = _solve_one(*_torch(qp), cfg, None, None)
        assert int(one.status) == int(batch.status[i]), i
        assert int(one.iterations) == int(batch.iterations[i]), i
        assert float(one_rho) == float(rho[i]), i
        for f in SOLUTION_FIELDS:
            torch.testing.assert_close(
                getattr(batch, f)[i], getattr(one, f), rtol=0.0, atol=LANE_TOL, msg=f"{i} {f}"
            )
    if name != "rti":
        assert int(batch.status[-1]) == STATUS_PRIMAL_INFEASIBLE
    if name == "adaptive":
        # lanes adapted, each to its own rho, and stopped at their own chunk
        assert len(set(rho.tolist())) > 2 and (rho != cfg.rho).all()
        assert len(set(batch.iterations.tolist())) > 2
        assert (batch.status[:-1] == STATUS_SOLVED).all()


def test_warm_started_lanes_equal_single_solves(lanes):
    """x0 and y0 with the scenario axis, each lane from its own start."""
    qps, stacked = lanes
    rng = np.random.default_rng(1)
    x0 = rng.normal(scale=0.1, size=(len(qps), 20)).astype(np.float32)
    y0 = rng.normal(scale=0.1, size=(len(qps), 30)).astype(np.float32)
    cfg = ADMMConfig()
    batch = solve_box_qp(*_torch(stacked), cfg, torch.as_tensor(x0), torch.as_tensor(y0))
    for i, qp in enumerate(qps):
        one = solve_box_qp(*_torch(qp), cfg, torch.as_tensor(x0[i]), torch.as_tensor(y0[i]))
        assert int(one.iterations) == int(batch.iterations[i])
        torch.testing.assert_close(batch.x[i], one.x, rtol=0.0, atol=LANE_TOL)


def test_one_lane_rho_moves_no_other(lanes):
    """A batch of one QP and the same QP among others end identically:
    a refactor of one lane leaves the others' operators alone."""
    qps, stacked = lanes
    cfg = ADMMConfig()
    full, full_rho = _solve_lanes(*_torch(stacked), cfg, None, None)
    pair_, pair_rho = _solve_lanes(*_torch([s[[0, 3]] for s in stacked]), cfg, None, None)
    for j, i in enumerate((0, 3)):
        assert float(pair_rho[j]) == float(full_rho[i])
        assert torch.equal(pair_.x[j], full.x[i])


@pytest.mark.parametrize("name", ["adaptive", "fixed_rho"])
def test_lanes_match_jax_vmap(lanes, name):
    qps, stacked = lanes
    jcfg, cfg = JADMMConfig(**CONFIGS[name]), ADMMConfig(**CONFIGS[name])
    ref = jax.jit(jax.vmap(lambda *qp: jax_solve(*qp, jcfg)))(*(jnp.asarray(s) for s in stacked))
    ours = solve_box_qp(*_torch(stacked), cfg)
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    solved = ours.status.numpy() == STATUS_SOLVED
    assert solved.sum() == len(qps) - 1
    np.testing.assert_allclose(ours.x.numpy()[solved], np.asarray(ref.x)[solved], **X_TOL)


def test_lanes_match_jax_vmap_rti(lanes):
    _, stacked = lanes
    kw = CONFIGS["rti"]
    ref = jax.jit(jax.vmap(lambda *qp: jax_solve(*qp, JADMMConfig(**kw))))(
        *(jnp.asarray(s) for s in stacked)
    )
    ours = solve_box_qp(*_torch(stacked), ADMMConfig(**kw))
    assert (ours.iterations.numpy() == 100).all()
    np.testing.assert_array_equal(ours.status.numpy(), np.asarray(ref.status))
    feasible = slice(0, -1)  # the infeasible lane's iterates grow without bound
    np.testing.assert_allclose(ours.x.numpy()[feasible], np.asarray(ref.x)[feasible], **X_TOL)


def _certificate_qps(layout, lanes, mpc):
    """Three QPs of one layout, the last primal infeasible, and the rows
    (i, j) that certify it: dy = +1 on row i and -1 on row j (unscaled)
    has A'dy = 0 and u_i - l_j < 0. ``box``: the control QP (A = [A_d; I])
    of three windows, the last with its first dense row made the identity
    row of variable 0 and pinned to 5 while that variable's box row is
    pinned to 0. ``dense``: three random QPs, the last two copies of a row
    pinned to 0 and to 5 (``_infeasible_qp``)."""
    if layout == "dense":
        return [_torch(qp) for qp in lanes[0][-3:]], (0, 1)
    qps = []
    for ref in _tracks(CONTROL["horizon"])[:3]:
        qp = mpc._prepare(mpc.initial_state(), torch.as_tensor(ref), 28.0, False, 0.0)[2]
        qps.append([t.clone() for t in qp])
    P, q, A, l, u = qps[-1]
    m_d = A.shape[0] - A.shape[1]
    A[0] = A[m_d]
    l[0] = u[0] = 5.0
    l[m_d] = u[m_d] = 0.0
    return qps, (m_d, 0)


@pytest.mark.parametrize("check", ["residuals", "certificate"])
@pytest.mark.parametrize("layout", ["box", "dense"])
def test_one_qp_equals_its_lane_in_the_scaled_problem(lanes, mpcs, layout, check):
    """The scaled problem, its residual check and its infeasibility
    certificate take one QP (q (n,)) or lanes (q (B, n)) with the same
    arithmetic: one QP alone gives, bit for bit on the CPU, what its lane
    of a three-lane call gives. ``_solve_one`` runs this code as
    ``_solve_lanes`` and the batched solver do."""
    qps, (i, j) = _certificate_qps(layout, lanes, mpcs[0])
    box = layout == "box"
    stacked = [torch.stack(t) for t in zip(*qps)]
    B, n, m = len(qps), stacked[1].shape[-1], stacked[3].shape[-1]
    rng = np.random.default_rng(11)

    def draw(*shape):
        return torch.as_tensor(rng.normal(scale=0.5, size=shape).astype(np.float32))

    cfg = ADMMConfig()
    x0, y0, x, y, z = draw(B, n), draw(B, m), draw(B, n), draw(B, m), draw(B, m)
    lane_sp, *lane_start = _scaled_problem(*stacked, cfg, x0, y0, box)
    if check == "residuals":
        lane_out = lane_sp.residuals(x, y, z)
    else:
        # unscaled: the last lane +1 on row i and -1 on row j; the others
        # +1 and -1 on two of their loose rows, a support of about 2e30
        # that no lane may see of another's
        unit = torch.zeros(B, m)
        unit[-1, i], unit[-1, j] = 1.0, -1.0
        loose = (stacked[4][:-1] >= 1e29) & (stacked[3][:-1] <= -1e29)
        first, second = loose.to(torch.int8).argsort(dim=-1, descending=True, stable=True)[:, :2].T
        rows = torch.arange(B - 1)
        assert loose[rows, first].all() and loose[rows, second].all()
        unit[rows, first], unit[rows, second] = 1.0, -1.0
        dy = unit / lane_sp.e
        lane_out = (lane_sp.certificate(dy),)
        assert lane_out[0].tolist() == [False, False, True]
    for b, qp in enumerate(qps):
        sp, *start = _scaled_problem(*qp, cfg, x0[b], y0[b], box)
        for f in ("Ps", "qs", "As", "ls", "us", "c", "d", "e", "A_chunk", "g"):
            want = getattr(lane_sp, f)
            assert (want is None) == (not box and f == "g"), f
            if want is not None:
                assert torch.equal(getattr(sp, f), want[b]), f"{b} {f}"
        for got, want in zip(start, lane_start):
            assert torch.equal(got, want[b]), b
        if check == "residuals":
            out = sp.residuals(x[b], y[b], z[b])
        else:
            out = (sp.certificate(dy[b]),)
        for k, (got, want) in enumerate(zip(out, lane_out)):
            assert got.dim() == 0 and torch.equal(got, want[b]), f"{b} output {k}"


# -- the control step -----------------------------------------------------------


def _tracks(horizon):
    tracks = [
        get_straight_track(200.0, horizon),
        get_hairpin_track(25.0, horizon),
        get_chicane_track(40.0, 10.0, horizon),
        get_hairpin_track(40.0, horizon, angle=0.5),
    ]
    return np.stack([np.asarray(with_widths(t), np.float32) for t in tracks])


@pytest.fixture(scope="module")
def mpcs():
    ours = SpatialMPC(
        MPCConfig(constraints=SpeedProfileConstraints(**CONS), **CONTROL),
        SpatialBicycleModel(VehicleParams(), CONS["v_min"], CONS["v_max"]),
        device="cpu",
    )
    ref = JMPC(
        JConfig(constraints=JConstraints(**CONS), **CONTROL),
        JModel(JVehicle(), CONS["v_min"], CONS["v_max"]),
    )
    return ours, ref


def test_batched_get_control_matches_jax(mpcs):
    """tests/test_mpc.py's four tracks: a cold step and a warm one."""
    ours, ref = mpcs
    refs = _tracks(CONTROL["horizon"])
    jstates = jax.vmap(lambda: ref.initial_state(), axis_size=len(refs))()
    states = ours.initial_state(len(refs))
    for step in range(2):
        jstates, jdiags = ref.batched_get_control(jstates, jnp.asarray(refs))
        states, diags = ours.batched_get_control(states, refs)
        np.testing.assert_array_equal(states.solved.numpy(), np.asarray(jstates.solved))
        assert bool(states.solved.all()), step
        for f in ("projected_control", "cum_time", "prediction"):
            np.testing.assert_allclose(
                getattr(states, f).numpy(), np.asarray(getattr(jstates, f)),
                err_msg=f"step {step} {f}", **JAX_STEP_TOL,
            )
        np.testing.assert_array_equal(diags.control_status.numpy(), np.asarray(jdiags.control_status))


def test_batched_get_control_equals_get_control_per_lane(mpcs):
    """Each lane is ``get_control`` on its scenario alone, with per-lane
    speed caps and offsets and shared flags: within tests/test_mpc.py's
    2e-3, and on the CPU bit for bit."""
    ours, _ = mpcs
    refs = _tracks(CONTROL["horizon"])
    v_max = np.array([28.0, 20.0, 24.0, 30.0], np.float32)
    offset = np.array([0.0, 0.3, -0.2, 0.1], np.float32)
    states, diags = ours.batched_get_control(
        ours.initial_state(len(refs)), refs, torch.as_tensor(v_max), False, torch.as_tensor(offset)
    )
    for i in range(len(refs)):
        one, one_diags = ours.get_control(
            ours.initial_state(), refs[i], float(v_max[i]), False, float(offset[i])
        )
        assert bool(one.solved) == bool(states.solved[i])
        assert int(one_diags.control_iterations) == int(diags.control_iterations[i])
        for f in ("projected_control", "cum_time", "prediction", "qp_x", "qp_y"):
            got, want = getattr(states, f)[i].numpy(), getattr(one, f).numpy()
            np.testing.assert_allclose(got, want, err_msg=f"{i} {f}", **SINGLE_STEP_TOL)
            np.testing.assert_array_equal(got, want, err_msg=f"{i} {f}")


def test_batched_get_control_takes_scalars_for_every_lane(mpcs):
    """A scalar speed cap, localisation flag or offset applies to every
    lane, as the same value written out per lane."""
    ours, _ = mpcs
    refs = _tracks(CONTROL["horizon"])
    B = len(refs)
    a, _ = ours.batched_get_control(ours.initial_state(B), refs, 22.0, True, 0.2)
    b, _ = ours.batched_get_control(
        ours.initial_state(B), refs, torch.full((B,), 22.0), torch.ones(B, dtype=torch.bool),
        torch.full((B,), 0.2),
    )
    assert torch.equal(a.projected_control, b.projected_control)


def test_batched_get_control_fixed_iterations(mpcs):
    """The real-time-iteration budget: every lane runs it, as get_control."""
    ours, _ = mpcs
    rti = SpatialMPC(dataclasses.replace(ours.config, rti_iterations=50), ours.model, device="cpu")
    refs = _tracks(CONTROL["horizon"])
    states, diags = rti.batched_get_control(rti.initial_state(len(refs)), refs)
    assert (diags.control_iterations == 50).all()
    for i in range(len(refs)):
        one, _ = rti.get_control(rti.initial_state(), refs[i])
        np.testing.assert_array_equal(states.projected_control[i].numpy(), one.projected_control.numpy())


# -- the closed loop ------------------------------------------------------------


def _per_scenario_run(sweep, grid: SweepGrid, n_steps: int):
    """``LapSweep.run`` as it was before the scenario axis: each scenario
    alone, one ``get_control`` solve per step."""
    localised = sweep._speeds is not None
    final, rows = [], []
    for b in range(grid.start_index.shape[0]):
        row = SweepGrid(*(getattr(grid, f.name)[b] for f in dataclasses.fields(grid)))
        car = sweep._init_car(row)
        state = sweep.mpc.initial_state()
        _, prev_i0 = sweep._ego_window(car)
        per_step = []
        for _ in range(n_steps):
            ref, i0 = sweep._ego_window(car)
            state = shift_warm_start(state, sweep._shift_stages(i0, prev_i0), sweep.mpc.horizon)
            state, diags = sweep.mpc.get_control(
                state, ref,
                v_max_runtime=sweep._runtime_v_max(row.v_max, i0),
                is_localised=localised,
            )
            car, metrics = sweep._integrate(car, state, i0)
            metrics["control_iterations"] = diags.control_iterations
            metrics["control_status"] = diags.control_status
            per_step.append(metrics)
            prev_i0 = i0
        final.append(car)
        rows.append({k: torch.stack([m[k] for m in per_step]) for k in per_step[0]})
    cars = CarState(
        *(torch.stack([getattr(c, f.name) for c in final]) for f in dataclasses.fields(CarState))
    )
    return cars, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.fixture(scope="module")
def runs(pair):
    """LapSweep.run, the old per-scenario loop and JAX's run, B = 4 over
    15 steps on one grid."""
    js, ts, _ = pair
    grid = _grid(7)
    cars, metrics = ts.run(sweep_grid_from_numpy(grid, device="cpu"), 15)
    loop_cars, loop_metrics = _per_scenario_run(ts, sweep_grid_from_numpy(grid, device="cpu"), 15)
    jcars, jmetrics = js.run(_jgrid(grid), 15)
    return (cars, metrics), (loop_cars, loop_metrics), (jcars, jmetrics)


def test_run_matches_jax_run(pair, runs):
    js, ts, _ = pair
    (cars, metrics), _, (jcars, jmetrics) = runs
    assert metrics["v"].shape == (4, 15)
    np.testing.assert_allclose(metrics["v"].numpy(), np.asarray(jmetrics["v"]), **LOOP_TOL)
    np.testing.assert_allclose(cars.x.numpy(), np.asarray(jcars.x), **LOOP_TOL)
    np.testing.assert_array_equal(metrics["solved"].numpy(), np.asarray(jmetrics["solved"]))
    ours, ref = ts.summarise(metrics, 15), js.summarise(jmetrics, 15)
    assert set(ours) == set(ref)
    assert ours["solve_success_rate"] == ref["solve_success_rate"] == 1.0


def test_run_matches_the_per_scenario_loop(runs):
    (cars, metrics), (loop_cars, loop_metrics), _ = runs
    assert set(metrics) == set(loop_metrics)
    for k in ("v", "offtrack"):
        np.testing.assert_allclose(metrics[k].numpy(), loop_metrics[k].numpy(), err_msg=k, **LOOP_TOL)
    np.testing.assert_allclose(cars.x.numpy(), loop_cars.x.numpy(), **LOOP_TOL)
    np.testing.assert_array_equal(metrics["map_index"].numpy(), loop_metrics["map_index"].numpy())
    np.testing.assert_array_equal(
        metrics["control_iterations"].numpy(), loop_metrics["control_iterations"].numpy()
    )
