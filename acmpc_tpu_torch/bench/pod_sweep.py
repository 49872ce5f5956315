"""The parallel layer across ranks: the sharded closed-loop sweep and the
horizon-sharded speed profiles, each rank a process.

Three cases, each run by ``launch`` in ``ranks`` processes (a file store
for the rendezvous) that write their results to a directory:

* ``sweep``: ``sharded_lap_sweep`` at the launch CLI's operating point
  (synth_nordschleife, monza's racing control at horizon 50 with a
  real-time-iteration budget of 50 ADMM iterations, 32 scenarios a rank,
  25 steps, one global grid drawn on the host from seed 0): one untimed
  run, then one timed run with the ADMM chunk launches counted; each
  rank's speeds, launches, fleet summary and collective calls;
* ``profiles``: ``compute_map_speed_profile(mesh=...)`` (monza's map
  limits) on synth_nordschleife's 43,940 centre points and on monza's
  map; ``solve_speed_profile_admm_sharded`` on a 2,048-point track
  (tests/test_horizon_sharded.py's, ``max_iter`` 20,000); the SPIKE
  solve at N = 43,940; and the cost of one collective call (a 0-d psum,
  and a one-element shift), each timed on the rank's device;
* ``submesh``: ``make_mesh(1)`` made by every rank: rank 0 runs
  ``sharded_get_control`` (monza's racing control at horizon 50, to
  convergence) on two battery windows, and ``batched_get_control`` on the
  same for reference; every other rank holds no rows, and its collective
  raises.

``single_sweep`` and ``single_profiles`` compute the one-process
references on one device, and ``compare`` holds the sharded results
against them. On the card, ranks that share it name ``backend="gloo"``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from acmpc_tpu_torch.cli.launch_pod import (
    HALF_WIDTH,
    MAP,
    SCENARIOS_PER_CHIP as SCENARIOS_PER_RANK,
    STEPS,
    build_sweep,
    global_grid,
    racing_mpc,
)
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.geometry.tracks import battery
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC
from acmpc_tpu_torch.ops.admm_chunk import admm_chunk
from acmpc_tpu_torch.ops.tridiag import tridiag_solve
from acmpc_tpu_torch.ops.tridiag_sharded import tridiag_solve_sharded
from acmpc_tpu_torch.parallel.mesh import (
    make_mesh,
    rank_device,
    scenario_sharding,
    sharded_get_control,
)
from acmpc_tpu_torch.parallel.multihost import (
    grid_sharding,
    initialize_distributed,
    make_pod_mesh,
    put_global,
    sharded_lap_sweep,
    spawn_ranks,
)
from acmpc_tpu_torch.qp.admm import ADMMConfig
from acmpc_tpu_torch.qp.speed_profile import (
    SpeedProfileConstraints,
    solve_speed_profile_admm,
    solve_speed_profile_admm_sharded,
)

ROOT = pathlib.Path(__file__).resolve().parents[2]
PROFILE_MAPS = {"synth_nordschleife": ROOT / MAP, "monza": ROOT / "data" / "maps" / "monza.npz"}
# tests/test_horizon_sharded.py's ADMM profile: its track and constraints
ADMM_POINTS, ADMM_MAX_ITER, ADMM_V_MAX = 2048, 20000, 28.0
ADMM_CONS = SpeedProfileConstraints(
    v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0
)
SPIKE_N = 43940
# timed repetitions of a SPIKE solve and of one collective call
SPIKE_REPS, COLLECTIVE_REPS = 20, 200
# seconds a launch may take, the ranks' start and every case
RANK_TIMEOUT = 600
# the sub-mesh case's scenarios
SUBMESH_WINDOWS = ("curve", "chicane")


def profile_path(mpc: SpatialMPC, name: str):
    """A map's closed centreline (the first point repeated at the end) as
    a path: one waypoint a centre point."""
    centre = load_track_map(PROFILE_MAPS[name], device="cpu").centre.numpy()
    closed = np.concatenate([centre, centre[:1]])
    xyw = np.concatenate([closed, np.full((len(closed), 1), 2 * HALF_WIDTH)], axis=1)
    return mpc.construct_waypoints(xyw.astype(np.float32))


def admm_track() -> tuple[np.ndarray, np.ndarray]:
    """tests/test_horizon_sharded.py's smooth 2,048-point track."""
    rng = np.random.default_rng(1)
    theta = np.linspace(0, 2 * np.pi, ADMM_POINTS, endpoint=False)
    kappas = (0.02 * np.sin(3 * theta) + 0.015 * np.sin(7 * theta)).astype(np.float32)
    return rng.uniform(1.5, 3.0, ADMM_POINTS).astype(np.float32), kappas


def spike_system(n: int = SPIKE_N):
    """A diagonally dominant system shaped as the speed ADMM's x-update."""
    rng = np.random.default_rng(5)
    off = -rng.uniform(0.0, 1.0, n).astype(np.float32)
    diag = (np.abs(off) + np.abs(np.roll(off, 1)) + rng.uniform(1.0, 2.0, n)).astype(np.float32)
    sub = np.roll(off, 1)
    sub[0] = 0.0
    sup = off.copy()
    sup[-1] = 0.0
    return sub, diag, sup, rng.normal(size=n).astype(np.float32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps: int) -> float:
    """Mean ms a call of ``fn`` over ``reps`` calls after one warm call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def _wall(fn, device):
    """(fn(), its wall seconds, ended by a synchronise)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def launches_per_call(fn) -> int:
    """Kernel launches one call of ``fn`` makes: the CUDA runtime's launch
    calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("cudaLaunchKernel"))


def _host_ms(fn, reps: int) -> float:
    """Mean host ms a call, after one warm call (for calls that wait on
    the host anyway, as a gloo collective does)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def case_sweep(device, out: dict) -> dict:
    sweep = build_sweep(device)
    mesh = make_pod_mesh(device=device)
    grid = put_global(global_grid(SCENARIOS_PER_RANK * mesh.size, sweep.map.n_centre), grid_sharding(mesh))
    run = sharded_lap_sweep(sweep, mesh, STEPS)
    run(grid)  # first use of every shape
    admm_chunk.launches.clear()
    calls = dict(mesh.calls)
    (metrics, fleet), wall = _wall(lambda: run(grid), device)
    out["v"] = metrics["v"].cpu().numpy()
    return {
        "rank": mesh.rank,
        "wall_s": wall,
        "launches": dict(admm_chunk.launches),
        "collective_calls": {k: n - calls.get(k, 0) for k, n in mesh.calls.items()},
        **{k: float(v) for k, v in fleet.items()},
    }


def case_profiles(device, out: dict) -> dict:
    mesh = make_mesh(device=device)
    mpc = racing_mpc(device, rti=None)
    limits = load_config(ROOT / "configs" / "monza.yaml").map_speed_profile
    info = {"rank": mesh.rank}
    for name in PROFILE_MAPS:
        path = profile_path(mpc, name)
        prof, wall = _wall(
            lambda: mpc.compute_map_speed_profile(path, limits.ay_max, limits.a_min, mesh=mesh), device
        )
        out[f"map_{name}"] = prof.velocities.cpu().numpy()
        info[f"map_{name}_s"] = wall
    ds, kappas = (torch.as_tensor(a, device=device) for a in admm_track())
    rows = slice(mesh.rank * ADMM_POINTS // mesh.size, (mesh.rank + 1) * ADMM_POINTS // mesh.size)
    calls = dict(mesh.calls)
    sol, wall = _wall(lambda: solve_speed_profile_admm_sharded(
        ds[rows], kappas[rows], ADMM_CONS, mesh, v_max_runtime=ADMM_V_MAX,
        cfg=ADMMConfig(max_iter=ADMM_MAX_ITER),
    ), device)
    out["admm_v"] = sol.velocities.cpu().numpy()
    info.update(
        admm_s=wall, admm_iterations=int(sol.iterations), admm_status=int(sol.status),
        admm_collective_calls={k: n - calls.get(k, 0) for k, n in mesh.calls.items()},
    )
    per = SPIKE_N // mesh.size
    parts = [torch.as_tensor(a[mesh.rank * per:(mesh.rank + 1) * per], device=device)
             for a in spike_system()]
    out["spike_x"] = tridiag_solve_sharded(*parts, mesh).cpu().numpy()
    info["spike_ms"] = _timed(lambda: tridiag_solve_sharded(*parts, mesh), device, SPIKE_REPS)
    if device.type == "cuda":
        info["spike_launches"] = launches_per_call(lambda: tridiag_solve_sharded(*parts, mesh))
    scalar = torch.zeros((), device=device)
    info["psum_ms"] = _host_ms(lambda: float(mesh.psum(scalar)), COLLECTIVE_REPS)
    info["shift_ms"] = _host_ms(lambda: float(mesh.from_prev(scalar[None])[0]), COLLECTIVE_REPS)
    return info


def case_submesh(device, out: dict) -> dict:
    mesh = make_mesh(1, device=device)
    mpc = racing_mpc(device, rti=None)
    windows = battery(mpc.horizon)
    refs = torch.as_tensor(np.stack([windows[k] for k in SUBMESH_WINDOWS]), device=device)
    rows = scenario_sharding(mesh).local(refs)
    info = {"rank": mesh.global_rank, "is_member": mesh.is_member, "rows": len(rows)}
    if mesh.is_member:
        admm_chunk.launches.clear()
        states, fleet = sharded_get_control(mpc, mesh)(mpc.initial_state(len(rows)), rows)
        info["launches"] = dict(admm_chunk.launches)
        info["n_solved"] = int(fleet["n_solved"])
        out["projected_control"] = states.projected_control.cpu().numpy()
        batched, _ = mpc.batched_get_control(mpc.initial_state(len(refs)), refs)
        out["batched"] = batched.projected_control.cpu().numpy()
    else:
        try:
            mesh.psum(torch.zeros((), device=device))
        except RuntimeError as err:
            info["error"] = str(err)
    return info


CASES = {"sweep": case_sweep, "profiles": case_profiles, "submesh": case_submesh}


def rank_main(argv) -> None:
    """One rank of ``launch``: run the cases in order, write each one's
    results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", help="comma-separated: " + ",".join(CASES))
    ap.add_argument("directory")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    directory = pathlib.Path(args.directory)
    device = initialize_distributed(
        f"file://{directory}/store", args.world, args.rank, args.device, args.backend
    )
    try:
        for case in args.cases.split(","):
            out: dict = {}
            info = CASES[case](device, out)
            np.savez(directory / f"{case}{args.rank}.npz", **out)
            (directory / f"{case}{args.rank}.json").write_text(json.dumps(info))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def launch(cases, ranks: int, device=None, backend=None) -> dict:
    """Run ``cases`` in order in ``ranks`` processes; returns, a case,
    one (info, arrays) a rank in rank order."""
    flags = [] if device is None else ["--device", str(device)]
    flags += [] if backend is None else ["--backend", backend]
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(
            lambda rank: [
                sys.executable, "-m", "acmpc_tpu_torch.bench.pod_sweep",
                ",".join(cases), tmp, str(ranks), str(rank), *flags,
            ],
            ranks, RANK_TIMEOUT,
        )
        d = pathlib.Path(tmp)
        return {
            case: [
                (json.loads((d / f"{case}{r}.json").read_text()), dict(np.load(d / f"{case}{r}.npz")))
                for r in range(ranks)
            ]
            for case in cases
        }


def single_sweep(device, batch: int) -> dict:
    """The sweep case's grid of ``batch`` scenarios through
    ``LapSweep.run_fused`` in this process: speeds, the timed run's wall
    and launches."""
    device = rank_device(device)
    sweep = build_sweep(device)
    grid = put_global(global_grid(batch, sweep.map.n_centre), grid_sharding(make_mesh(device=device)))
    sweep.run_fused(grid, STEPS)
    admm_chunk.launches.clear()
    (_, metrics), wall = _wall(lambda: sweep.run_fused(grid, STEPS), device)
    return {
        "v": metrics["v"].cpu().numpy(),
        "wall_s": wall,
        "launches": dict(admm_chunk.launches),
        "summary": sweep.summarise(metrics, STEPS),
    }


def single_profiles(device) -> dict:
    """The profiles case's work in this process, unsharded: the two map
    profiles, the ADMM profile and the PCR solve of the SPIKE system."""
    device = rank_device(device)
    mpc = racing_mpc(device, rti=None)
    limits = load_config(ROOT / "configs" / "monza.yaml").map_speed_profile
    info = {}
    for name in PROFILE_MAPS:
        path = profile_path(mpc, name)
        prof, wall = _wall(lambda: mpc.compute_map_speed_profile(path, limits.ay_max, limits.a_min), device)
        info[f"map_{name}"] = prof.velocities.cpu().numpy()
        info[f"map_{name}_s"] = wall
    ds, kappas = (torch.as_tensor(a, device=device) for a in admm_track())
    sol, wall = _wall(lambda: solve_speed_profile_admm(
        ds, kappas, ADMM_CONS, v_max_runtime=ADMM_V_MAX, cfg=ADMMConfig(max_iter=ADMM_MAX_ITER)
    ), device)
    info.update(admm_v=sol.velocities.cpu().numpy(), admm_s=wall,
                admm_iterations=int(sol.iterations), admm_status=int(sol.status))
    parts = [torch.as_tensor(a, device=device) for a in spike_system()]
    info["pcr_x"] = tridiag_solve(*parts).cpu().numpy()
    info["pcr_ms"] = _timed(lambda: tridiag_solve(*parts), device, SPIKE_REPS)
    if device.type == "cuda":
        info["pcr_launches"] = launches_per_call(lambda: tridiag_solve(*parts))
    return info


def max_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference, in units in the last place of ``want``."""
    return float((np.abs(got - want) / np.spacing(np.abs(want))).max())


def compare(case: str, ranks_out: list, single: dict) -> dict:
    """The sharded results against the one-process ones."""
    infos = [info for info, _ in ranks_out]
    if case == "sweep":
        v = np.concatenate([arrays["v"] for _, arrays in ranks_out])
        return {
            "ranks": infos,
            "max_abs_v_err": float(np.abs(v - single["v"]).max()),
            "solves_per_s": v.size / max(i["wall_s"] for i in infos),
            "single_solves_per_s": single["v"].size / single["wall_s"],
            "single_launches": single["launches"],
        }
    out = {"ranks": infos}
    arrays = [a for _, a in ranks_out]
    for name in PROFILE_MAPS:
        key = f"map_{name}"
        out[f"{key}_max_abs_err"] = max(float(np.abs(a[key] - single[key]).max()) for a in arrays)
        out[f"{key}_max_ulps"] = max(max_ulps(a[key], single[key]) for a in arrays)
        out[f"{key}_bit_equal"] = all(np.array_equal(a[key], single[key]) for a in arrays)
        out[f"{key}_single_s"] = single[f"{key}_s"]
    admm_v = np.concatenate([a["admm_v"] for a in arrays])
    out.update(
        admm_max_abs_err=float(np.abs(admm_v - single["admm_v"]).max()),
        admm_single_iterations=single["admm_iterations"],
        admm_single_s=single["admm_s"],
        spike_max_abs_err=float(np.abs(np.concatenate([a["spike_x"] for a in arrays]) - single["pcr_x"]).max()),
        pcr_ms=single["pcr_ms"],
        pcr_launches=single.get("pcr_launches"),
    )
    return out


if __name__ == "__main__":
    rank_main(sys.argv[1:])
