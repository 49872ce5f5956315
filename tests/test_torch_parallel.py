"""The parallel layer on torch.distributed against the JAX package's
sharded functions (CPU).

The port's ranks are subprocesses (gloo, a file store for the rendezvous,
tests/torch_parallel_cases.py) at 2 and 4 ranks; JAX's side runs on a
mesh of the same size from the 8 virtual CPU devices of
tests/conftest.py. The same numpy inputs go to both. Every launch has a
timeout, so a rank that waits on a dead peer fails the test rather than
hanging the suite.

Tolerances, each beside its check:
* the SPIKE solve: 5e-6 against JAX's, as tests/test_horizon_sharded.py
  holds JAX's against the unsharded PCR (fp32 elementwise work in two
  libraries, and an interface solve by two LAPACKs);
* the sharded exact scan: bit-equal to the port's unsharded scan on the
  smooth tracks of tests/test_horizon_sharded.py, and within
  REAL_MAP_ULPS of it on the real maps (below, with its cause); 1e-5
  relative against JAX's (tests/test_torch_geometry.py: the slacks are
  summed in another order, Hillis-Steele doubling against XLA's
  associative scan);
* the sharded ADMM: the same iteration count as JAX's and as the port's
  unsharded solve, velocities within 1e-3 / 2e-3 (test_horizon_sharded);
* the control step: 5e-3 (the golden fixture's; two packages' fp32 KKT
  inverses differ in rounding); the closed loop: tests/test_torch_lap_sweep.py's
  LOOP_TOL.
"""

import fcntl
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from acmpc_tpu.bench import LapSweep as JSweep, SweepGrid as JGrid
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel, VehicleParams as JVehicle
from acmpc_tpu.geometry.path import construct_waypoints as jconstruct
from acmpc_tpu.geometry.tracks import get_hairpin_track, get_straight_track, with_widths
from acmpc_tpu.mpc.spatial_mpc import MPCConfig as JConfig, SpatialMPC as JMPC
from acmpc_tpu.ops.tridiag_sharded import tridiag_solve_sharded as j_tridiag_sharded
from acmpc_tpu.parallel import sharded_get_control as j_sharded_get_control
from acmpc_tpu.parallel.mesh import replicate_state as j_replicate_state
from acmpc_tpu.parallel.multihost import (
    grid_sharding as j_grid_sharding,
    sharded_full_lap as j_sharded_full_lap,
    sharded_lap_sweep as j_sharded_lap_sweep,
)
from acmpc_tpu.qp.admm import ADMMConfig as JADMMConfig
from acmpc_tpu.qp.speed_profile import (
    SpeedProfileConstraints as JConstraints,
    SpeedProfileSolution as JSolution,
    solve_speed_profile_admm_sharded as j_admm_sharded,
    solve_speed_profile_sharded as j_scan_sharded,
)
from acmpc_tpu_torch.cli.launch_pod import run_two_process_smoke
from acmpc_tpu_torch.geometry.path import construct_waypoints
from acmpc_tpu_torch.parallel import Mesh, make_mesh, scenario_sharding
from acmpc_tpu_torch.parallel.multihost import (
    check_cards,
    initialize_distributed,
    resolve_backend,
    spawn_ranks,
)
from acmpc_tpu_torch.qp.admm import ADMMConfig
from acmpc_tpu_torch.qp.speed_profile import (
    SpeedProfileConstraints,
    solve_speed_profile,
    solve_speed_profile_admm,
)

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
sys.path.insert(0, str(TESTS))
import torch_parallel_cases as cases  # noqa: E402
from test_horizon_sharded import _dd_tridiag, _track  # noqa: E402
from test_localise import make_asymmetric_map  # noqa: E402

WORLDS = (2, 4)
# seconds a launch may take: the ranks' start (torch, the port) and the
# cases; the cases take ~10 s of it at 4 ranks
RANK_TIMEOUT = 300
LOOP_TOL = dict(rtol=5e-3, atol=5e-2)
CONTROL_TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))


def _map_coords(n_pts=3001):
    """test_horizon_sharded's 3,001-point circuit: not a multiple of the ranks."""
    theta = np.linspace(0.0, 2.0 * np.pi, n_pts + 1)
    r = 800.0 + 90.0 * np.sin(3 * theta)
    return np.stack(
        [r * np.cos(theta), r * np.sin(theta), np.full_like(theta, 9.0)], axis=1
    ).astype(np.float32)


def _control_refs(batch):
    """test_parallel's straights and hairpins."""
    tracks = [
        get_straight_track(100.0, cases.CONTROL_HORIZON) if i % 2
        else get_hairpin_track(20.0 + i, cases.CONTROL_HORIZON)
        for i in range(batch)
    ]
    return np.stack([np.asarray(with_widths(t), np.float32) for t in tracks])


def _sweep_grid(batch, seed=1, n_map=800, v_max=20.0):
    rng = np.random.default_rng(seed)
    return {
        "start_index": rng.integers(0, n_map, batch).astype(np.int32),
        "lateral_offset": np.clip(1.5 * rng.normal(size=batch), -3.0, 3.0).astype(np.float32),
        "v_max": (v_max * rng.uniform(0.8, 1.1, batch)).astype(np.float32),
    }


def _inputs(world) -> dict:
    rng = np.random.default_rng(world)
    inp = {}
    for tag, (n, batch) in zip(cases.SCAN_SYSTEMS, ((1024, None), (1000 * world, None), (512, 3))):
        for k, v in zip(("sub", "diag", "sup", "rhs"), _dd_tridiag(rng, n, batch)):
            inp[f"tridiag/{tag}/{k}"] = v
    inp["scan/ds"], inp["scan/kappas"] = _track(4096)
    inp["admm/ds"], inp["admm/kappas"] = _track(2048)
    inp["map/coords"] = _map_coords()
    inp["control/refs"] = _control_refs(2 * world)
    tm = make_asymmetric_map(800)
    for k in ("centre", "left", "right"):
        inp[f"sweep/{k}"] = np.asarray(getattr(tm, k))
    for k, v in _sweep_grid(2 * world).items():
        inp[f"sweep/{k}"] = v
    inp["pod/run"] = np.ones(1)
    inp["realmap/run"] = np.ones(1)
    inp["submesh/refs"] = _control_refs(4)
    return inp


def _launch(directory, world, inp) -> None:
    np.savez(directory / "inputs.npz", **inp)
    script = str(TESTS / "torch_parallel_cases.py")
    spawn_ranks(
        lambda rank: [sys.executable, script, str(directory), str(world), str(rank)],
        world, RANK_TIMEOUT, env=_env(),
    )


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def ranks(request, tmp_path_factory):
    """(world, global inputs, one output dict a rank) of one launch.

    Under xdist the launch runs once a session whatever the distribution
    mode: the first worker to ask makes it, under a lock, in the
    directory the session's workers share; the others read its outputs.
    """
    world = request.param
    inp = _inputs(world)
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        directory = tmp_path_factory.mktemp(f"ranks{world}")
        _launch(directory, world, inp)
    else:
        directory = tmp_path_factory.getbasetemp().parent / f"torch_parallel_ranks{world}"
        directory.mkdir(exist_ok=True)
        with open(directory / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (directory / "done").exists():
                _launch(directory, world, inp)
                (directory / "done").touch()
    return world, inp, [dict(np.load(directory / f"rank{r}.npz")) for r in range(world)]


def _joined(outs, key, axis=-1):
    return np.concatenate([o[key] for o in outs], axis=axis)


def _jmesh(world, axis_names=("x",), shape=None):
    devices = np.asarray(jax.devices()[:world])
    return JMesh(devices.reshape(shape or (world,)), axis_names)


def _jshard(fn, world, in_specs, out_specs):
    return jax.jit(jax.shard_map(
        fn, mesh=_jmesh(world), in_specs=in_specs, out_specs=out_specs, check_vma=False
    ))


@pytest.mark.parametrize("tag", cases.SCAN_SYSTEMS)
def test_tridiag_solve_sharded_matches_jax(ranks, tag):
    world, inp, outs = ranks
    parts = [inp[f"tridiag/{tag}/{k}"] for k in ("sub", "diag", "sup", "rhs")]
    spec = P(None, "x") if parts[0].ndim == 2 else P("x")
    want = _jshard(
        lambda a, b, c, d: j_tridiag_sharded(a, b, c, d, "x"), world, (spec,) * 4, spec
    )(*(jnp.asarray(p) for p in parts))
    got = _joined(outs, f"tridiag/{tag}/x")
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-6)
    # and it solves the global system
    sub, diag, sup, rhs = parts
    lower = np.concatenate([np.zeros_like(got[..., :1]), sub[..., 1:] * got[..., :-1]], -1)
    upper = np.concatenate([sup[..., :-1] * got[..., 1:], np.zeros_like(got[..., :1])], -1)
    assert np.abs(lower + diag * got + upper - rhs).max() < 5e-5


def test_sharded_exact_scan_bit_equal(ranks):
    """Bit-equal to the port's unsharded scan: within a block the doubling
    groups each sum as the unsharded one does, and on this smooth track
    no chain of two or more slacks crosses a block edge (see
    solve_speed_profile_sharded)."""
    world, inp, outs = ranks
    ds, kappas = inp["scan/ds"], inp["scan/kappas"]
    got = _joined(outs, "scan/v")
    single = solve_speed_profile(
        torch.as_tensor(ds), torch.as_tensor(kappas), SpeedProfileConstraints(**cases.CONS),
        v_max_runtime=cases.V_MAX_RUNTIME,
    )
    np.testing.assert_array_equal(got, single.velocities.numpy())
    assert got[-1] == pytest.approx(cases.CONS["end_velocity"])  # the pin, last rank
    want = _jshard(
        lambda d, k: j_scan_sharded(
            d, k, JConstraints(**cases.CONS), "x", v_max_runtime=cases.V_MAX_RUNTIME,
            use_end_velocity=True,
        ),
        world, (P("x"), P("x")), P("x"),
    )(jnp.asarray(ds), jnp.asarray(kappas))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)


def test_sharded_admm_matches_jax(ranks):
    world, inp, outs = ranks
    ds, kappas = inp["admm/ds"], inp["admm/kappas"]
    cfg = JADMMConfig(max_iter=cases.ADMM_MAX_ITER)
    jsol = jax.jit(jax.shard_map(
        lambda d, k: j_admm_sharded(
            d, k, JConstraints(**cases.CONS), "x", v_max_runtime=cases.V_MAX_RUNTIME, cfg=cfg
        ),
        mesh=_jmesh(world), in_specs=(P("x"), P("x")),
        out_specs=_admm_specs(),
        check_vma=False,
    ))(jnp.asarray(ds), jnp.asarray(kappas))
    single = solve_speed_profile_admm(
        torch.as_tensor(ds), torch.as_tensor(kappas), SpeedProfileConstraints(**cases.CONS),
        v_max_runtime=cases.V_MAX_RUNTIME, cfg=ADMMConfig(max_iter=cases.ADMM_MAX_ITER),
    )
    for o in outs:  # every rank took the same decisions
        assert int(o["admm/status"]) == int(jsol.status) == 1
        assert int(o["admm/iterations"]) == int(jsol.iterations) == int(single.iterations)
    got = _joined(outs, "admm/v")
    np.testing.assert_allclose(got, np.asarray(jsol.velocities), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got, single.velocities.numpy(), rtol=1e-3, atol=2e-3)
    # the exchanges a rank makes: one halo element a side in each
    # constraint product, one all-gather a SPIKE solve, one pmax a check
    iters = int(outs[0]["admm/iterations"])
    checks = iters // ADMMConfig().check_every
    from_prev, from_next, gathers, pmaxes = outs[1]["admm/calls"]
    assert gathers == iters and pmaxes == checks
    assert from_next == iters + checks + 1  # A x each iteration, each check, the start
    assert from_prev == iters + 2 * checks  # A'y each iteration and check, K once a chunk
    # what a rank sends: one element a shift (none past the ends), 6
    # scalars an all-gather, the 10 residual maxima a pmax
    for o in outs:
        sent = dict(zip(("from_prev", "from_next", "all_gather", "pmax"), o["admm/elements"]))
        first, last = o is outs[0], o is outs[-1]
        assert sent["from_prev"] == (0 if last else from_prev)
        assert sent["from_next"] == (0 if first else from_next)
        assert sent["all_gather"] == 6 * gathers and sent["pmax"] == 10 * pmaxes


def _admm_specs():
    return JSolution(velocities=P("x"), status=P(), iterations=P(), r_prim=P(), r_dual=P())


def test_map_speed_profile_mesh_bit_equal(ranks):
    """compute_map_speed_profile(mesh=...) on 3,001 points (padded to a
    multiple of the ranks): bit-equal to the port's single-device
    profile, on every rank, and to JAX's within the scan tolerance."""
    world, inp, outs = ranks
    coords = inp["map/coords"]
    mpc = cases.make_mpc(cases.MAP_HORIZON)
    single = mpc.compute_map_speed_profile(
        construct_waypoints(torch.as_tensor(coords)), cases.MAP_AY_MAX, cases.MAP_A_MIN
    )
    for o in outs:
        np.testing.assert_array_equal(o["map/v"], single.velocities.numpy())
    jmpc = JMPC(
        JConfig(horizon=cases.MAP_HORIZON, constraints=JConstraints(**cases.CONS), **cases.CONTROL),
        JModel(JVehicle(), cases.CONS["v_min"], cases.CONS["v_max"]),
    )
    want = jmpc.compute_map_speed_profile(
        jconstruct(jnp.asarray(coords)), ay_max=cases.MAP_AY_MAX, a_min=cases.MAP_A_MIN,
        mesh=_jmesh(world),
    )
    np.testing.assert_allclose(outs[0]["map/v"], np.asarray(want.velocities), rtol=1e-5, atol=1e-4)


# the largest difference between the sharded and the unsharded profile
# of a real map, in units in the last place of the unsharded value: 2,
# measured on both maps at 2, 3 and 4 ranks (3 at 8 ranks). Braking
# chains at monza's map limit (a_min -0.15 m/s^2: 0.15-0.3 m/s a
# waypoint) cross a block edge, and their slacks are then summed block
# by block rather than in the unsharded doubling's grouping
# (_min_plus_scan_sharded).
REAL_MAP_ULPS = 2


@pytest.mark.parametrize("name", list(cases.PROFILE_MAPS))
def test_map_speed_profile_mesh_on_real_maps(ranks, name):
    """compute_map_speed_profile(mesh=...) on synth_nordschleife's 43,940
    centre points and on monza's map, monza's map limits: within
    REAL_MAP_ULPS of the port's unsharded profile, the same on every rank."""
    world, _, outs = ranks
    mpc = cases.racing_mpc("cpu", rti=None)
    limits = cases.load_config(ROOT / "configs" / "monza.yaml").map_speed_profile
    single = mpc.compute_map_speed_profile(
        cases.profile_path(mpc, name), limits.ay_max, limits.a_min
    ).velocities.numpy()
    got = outs[0][f"realmap/{name}"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"realmap/{name}"], got)
    ulps = np.abs(got - single) / np.spacing(np.abs(single))
    assert ulps.max() <= REAL_MAP_ULPS, (ulps.max(), int((ulps > 0).sum()))


def test_sharded_get_control_matches_jax(ranks):
    world, inp, outs = ranks
    refs = inp["control/refs"]
    jmpc = JMPC(
        JConfig(horizon=cases.CONTROL_HORIZON, constraints=JConstraints(**cases.CONS), **cases.CONTROL),
        JModel(JVehicle(), cases.CONS["v_min"], cases.CONS["v_max"]),
    )
    mesh = _jmesh(world, ("dp",))
    jrefs = jax.device_put(jnp.asarray(refs), NamedSharding(mesh, P("dp")))
    jstates, jfleet = j_sharded_get_control(jmpc, mesh)(j_replicate_state(jmpc, refs.shape[0]), jrefs)
    for o in outs:
        assert int(o["control/n_solved"]) == int(jfleet["n_solved"]) == refs.shape[0]
        assert int(o["control/worst_infeasibility_counter"]) == int(jfleet["worst_infeasibility_counter"])
    np.testing.assert_allclose(
        _joined(outs, "control/projected_control", axis=0),
        np.asarray(jstates.projected_control), **CONTROL_TOL,
    )


@pytest.fixture(scope="module")
def jax_sweep():
    jmpc = JMPC(
        JConfig(horizon=cases.CONTROL_HORIZON, constraints=JConstraints(**cases.CONS), **cases.CONTROL),
        JModel(JVehicle(), cases.CONS["v_min"], cases.CONS["v_max"]),
    )
    return JSweep(jmpc, make_asymmetric_map(800), half_width=cases.HALF_WIDTH, dt=cases.DT)


def _jgrid(inp, mesh):
    grid = JGrid(**{k: jnp.asarray(inp[f"sweep/{k}"]) for k in ("start_index", "lateral_offset", "v_max")})
    return jax.device_put(grid, j_grid_sharding(mesh))


def test_sharded_lap_sweep_matches_jax(ranks, jax_sweep):
    world, inp, outs = ranks
    mesh = _jmesh(world, ("host", "chip"), (2, world // 2))
    metrics, fleet = j_sharded_lap_sweep(jax_sweep, mesh, cases.SWEEP_STEPS)(_jgrid(inp, mesh))
    for o in outs:
        assert int(o["sweep/n_solves"]) == int(fleet["n_solves"]) == 2 * world * cases.SWEEP_STEPS
        assert int(o["sweep/n_solved"]) >= 0.9 * int(fleet["n_solves"])
        np.testing.assert_allclose(o["sweep/mean_speed"], float(fleet["mean_speed"]), **LOOP_TOL)
    np.testing.assert_allclose(_joined(outs, "sweep/v", axis=0), np.asarray(metrics["v"]), **LOOP_TOL)


def test_sharded_full_lap_matches_jax(ranks, jax_sweep):
    world, inp, outs = ranks
    mesh = _jmesh(world, ("host", "chip"), (2, world // 2))
    fleet = j_sharded_full_lap(jax_sweep, mesh, cases.FULL_LAP_STEPS, cases.DT)(_jgrid(inp, mesh))
    got = {k.removeprefix("full_lap/"): v for k, v in outs[0].items() if k.startswith("full_lap/")}
    assert set(got) == set(fleet)
    for k in ("n_scenarios", "n_solves", "n_solved", "completed_laps", "lap_steps_sum",
              "fail_max_iter", "fail_infeasible"):
        assert int(got[k]) == int(fleet[k]), k
    assert int(got["n_solves"]) == 2 * world * cases.FULL_LAP_STEPS
    # no lap in 3 s of driving: both report the int32 maximum
    assert int(got["lap_steps_min"]) == int(fleet["lap_steps_min"])
    for k in ("worst_offtrack", "mean_speed"):
        np.testing.assert_allclose(got[k], float(fleet[k]), err_msg=k, **LOOP_TOL)


def test_pod_mesh_coordinates_and_collectives(ranks):
    """make_pod_mesh(hosts=2): rank = host * per_host + chip, and the
    reductions over one axis and over both."""
    world, _, outs = ranks
    per_host = world // 2
    values = [10.0 * r + 1 for r in range(world)]
    for r, o in enumerate(outs):
        host, chip = divmod(r, per_host)
        assert list(o["pod/coords"]) == [host, chip]
        same_host = [values[host * per_host + c] for c in range(per_host)]
        same_chip = [values[h * per_host + chip] for h in range(2)]
        assert float(o["pod/psum_chip"]) == sum(same_host)
        assert float(o["pod/pmax_chip"]) == max(same_host)
        assert float(o["pod/psum_host"]) == sum(same_chip)
        assert float(o["pod/pmax_host"]) == max(same_chip)
        assert float(o["pod/psum_both"]) == sum(values)
        assert float(o["pod/pmax_both"]) == max(values)
        assert int(o["pod/index_host"]) == host and int(o["pod/index_chip"]) == chip
        assert int(o["pod/index_both"]) == r
        assert list(o["pod/gather_chip"]) == same_host
        assert float(o["pod/next_chip"]) == (values[r + 1] if chip < per_host - 1 else -1.0)
        assert float(o["pod/prev_host"]) == (values[r - per_host] if host > 0 else -1.0)


def _sub_meshes(world):
    return (1, 2) if world > 2 else (1,)


def test_sub_mesh_holds_the_first_ranks(ranks):
    """make_mesh(n) below the world size: ranks 0..n-1 are its members,
    in order, and reduce over it alone; the others hold no rows."""
    world, inp, outs = ranks
    batch = len(inp["submesh/refs"])
    for n in _sub_meshes(world):
        tag = f"submesh/{n}"
        members = [r for r, o in enumerate(outs) if bool(o[f"{tag}/is_member"])]
        assert members == list(range(n))
        for r, o in enumerate(outs):
            assert int(o[f"{tag}/rows"]) == (batch // n if r < n else 0)
            if r < n:
                assert int(o[f"{tag}/index"]) == r
                assert float(o[f"{tag}/psum"]) == sum(10.0 * k + 1 for k in range(n))


def test_sub_mesh_outsiders_collectives_raise(ranks):
    """A collective on a rank outside the sub-mesh raises and names the
    rank and the mesh's size (it never waits on the members)."""
    world, _, outs = ranks
    for n in _sub_meshes(world):
        for r in range(n, world):
            msg = str(outs[r][f"submesh/{n}/error"])
            assert f"rank {r} " in msg and f"mesh of {n} ranks" in msg, msg


def test_make_mesh_above_the_world_raises(ranks):
    world, _, outs = ranks
    for o in outs:
        msg = str(o["submesh/above_error"])
        assert f"make_mesh({world + 1})" in msg and f"has {world} rank" in msg, msg


def test_sub_mesh_sharded_get_control_matches_batched(ranks):
    """On the members, the sharded step is batched_get_control on their
    rows: equal to rank 0's batched_get_control on the whole batch (each
    lane is solved as it would be alone), and to JAX's
    batched_get_control."""
    world, inp, outs = ranks
    refs = inp["submesh/refs"]
    jmpc = JMPC(
        JConfig(horizon=cases.CONTROL_HORIZON, constraints=JConstraints(**cases.CONS), **cases.CONTROL),
        JModel(JVehicle(), cases.CONS["v_min"], cases.CONS["v_max"]),
    )
    jstates, _ = jmpc.batched_get_control(j_replicate_state(jmpc, len(refs)), jnp.asarray(refs))
    for n in _sub_meshes(world):
        tag = f"submesh/{n}"
        got = np.concatenate([outs[r][f"{tag}/projected_control"] for r in range(n)])
        np.testing.assert_array_equal(got, outs[0]["submesh/batched"])
        np.testing.assert_allclose(got, np.asarray(jstates.projected_control), **CONTROL_TOL)
        for r in range(n):
            assert int(outs[r][f"{tag}/n_solved"]) == len(refs)


def test_one_process_make_mesh_above_the_world_raises():
    with pytest.raises(ValueError, match="has 1 rank"):
        make_mesh(2, device="cpu")


def test_one_process_mesh_needs_no_group():
    """Without torch.distributed a mesh is one rank and every collective
    returns its input."""
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.backend is None and mesh.axis_index() == 0
    x = torch.arange(3.0)
    assert torch.equal(mesh.psum(x), x) and torch.equal(mesh.pmax(x), x)
    assert torch.equal(mesh.all_gather(x), x[None])
    assert torch.equal(mesh.from_prev(x, fill=7.0), torch.full((3,), 7.0))
    assert sum(mesh.calls.values()) == 0
    rows = scenario_sharding(mesh).local(np.arange(6))
    assert rows.tolist() == list(range(6))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        Mesh({"dp": 2}, "cpu")


def test_launch_pod_cli_two_ranks():
    """The launch CLI as two gloo ranks on the CPU, 1 scenario a chip, 3
    steps; then --full-lap bounded to 3 steps. Checked as
    tests/test_multiprocess_distributed.py checks JAX's."""
    summary = run_two_process_smoke(
        scenarios_per_chip=1, steps=3, device="cpu", env=_env(), timeout=RANK_TIMEOUT
    )
    assert summary["hosts"] == 2 and summary["chips"] == 2
    assert summary["mesh"] == {"host": 2, "chip": 1}
    assert summary["scenarios"] == 2 and summary["backend"] == "gloo"
    assert summary["success_rate"] == 1.0
    assert summary["solves_per_s"] > 0
    lap = run_two_process_smoke(
        scenarios_per_chip=1, steps=3, full_lap=True, device="cpu", env=_env(), timeout=RANK_TIMEOUT
    )
    assert lap["mode"] == "full_lap" and lap["hosts"] == 2
    assert lap["total_solves"] == lap["scenarios"] * 3
    assert lap["solve_success_rate"] == 1.0
    assert lap["completed_laps"] == 0  # 0.3 s of driving, 22 km lap


def test_missing_map_raises():
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        run_two_process_smoke(
            scenarios_per_chip=1, steps=1, map_path="data/maps/no_such_map.npy",
            device="cpu", env=_env(), timeout=RANK_TIMEOUT,
        )


def test_failed_rank_makes_the_launch_raise(tmp_path):
    """Rank 1 dies before the rendezvous; rank 0 would wait for it for
    the store's whole timeout, but the launcher kills it and raises."""
    args = [
        sys.executable, "-m", "acmpc_tpu_torch.cli.launch_pod", "--device", "cpu",
        "--coordinator", f"file://{tmp_path}/store", "--num-hosts", "2",
    ]
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code 2"):
        spawn_ranks(
            lambda rank: args + (["--host-id", "0"] if rank == 0 else ["--steps", "nan"]),
            2, RANK_TIMEOUT, env=_env(),
        )


def test_backend_policy():
    """nccl on the CPU, nccl with more ranks on a host than cards, and a
    CUDA request without a card all raise; nothing switches silently."""
    with pytest.raises(ValueError, match="gloo"):
        resolve_backend(torch.device("cpu"), "nccl")
    assert resolve_backend(torch.device("cpu"), None) == "gloo"
    assert resolve_backend(torch.device("cuda"), None) == "nccl"
    assert resolve_backend(torch.device("cuda"), "gloo") == "gloo"
    with pytest.raises(ValueError, match="backend='gloo'"):
        check_cards("nccl", local_ranks=2, cards=1)
    check_cards("gloo", local_ranks=2, cards=1)
    check_cards("nccl", local_ranks=1, cards=1)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed(num_processes=2, device="cuda", coordinator_address="file:///nowhere")
