"""Pod launch CLI: the closed-loop robustness sweep sharded over ranks.

Counterpart of ``acmpc_tpu/cli/launch_pod.py``. Run one copy of this
process per rank with the same coordinator; the scenarios shard over the
("host", "chip") mesh (``parallel/multihost.py``, one rank a host by
default) and the only traffic between ranks is the few-scalar fleet
summary. Rank 0 prints it as one JSON line.

One rank on the card needs no flags:

  python -m acmpc_tpu_torch.cli.launch_pod --map data/maps/synth_nordschleife.npy

Two ranks, each on a card of its own (nccl), e.g. on two machines:

  host0$ python -m acmpc_tpu_torch.cli.launch_pod --coordinator host0:8476 --num-hosts 2 --host-id 0
  host1$ python -m acmpc_tpu_torch.cli.launch_pod --coordinator host0:8476 --num-hosts 2 --host-id 1

Ranks that share a card (or run on the CPU, ``--device cpu``) name gloo:
``--backend gloo``. ``run_two_process_smoke`` launches two ranks on one
machine, with a file store for the rendezvous.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.dynamics import SpatialBicycleModel
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC
from acmpc_tpu_torch.parallel.multihost import (
    grid_sharding,
    initialize_distributed,
    make_pod_mesh,
    put_global,
    sharded_full_lap,
    sharded_lap_sweep,
    spawn_ranks,
)

ROOT = pathlib.Path(__file__).resolve().parents[2]
# the operating point: the map, scenarios a rank, steps, the control's
# horizon and real-time-iteration budget, the grid's top speed, the
# sweep's half width and time step
MAP = "data/maps/synth_nordschleife.npy"
SCENARIOS_PER_CHIP, STEPS, HORIZON, RTI, V_MAX = 32, 25, 50, 50, 24.0
HALF_WIDTH, DT = 4.5, 0.1


def racing_mpc(device, horizon: int = HORIZON, rti: int | None = RTI) -> SpatialMPC:
    """monza's racing control at ``horizon``, ``rti`` ADMM iterations a
    step (None: to convergence)."""
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=horizon, rti_iterations=rti)
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle,
        min_velocity=control.constraints.v_min,
        max_velocity=control.constraints.v_max,
    )
    return SpatialMPC(control, model, device=device)


def build_sweep(device, map_path=MAP, horizon: int = HORIZON) -> LapSweep:
    """The sweep this CLI runs: monza's racing control on ``map_path``."""
    tm = load_track_map(_resolve(map_path), device=device)
    return LapSweep(racing_mpc(device, horizon), tm, half_width=HALF_WIDTH, dt=DT)


def global_grid(batch: int, n_map_points: int, v_max: float = V_MAX) -> SweepGrid:
    """The global grid of ``batch`` scenarios, drawn on the host from seed
    0: every rank, and a one-process run, sees the same one."""
    return SweepGrid.perturbed(torch.Generator().manual_seed(0), batch, n_map_points, v_max=v_max)


def run_two_process_smoke(
    scenarios_per_chip=2,
    steps=2,
    timeout=420,
    full_lap=False,
    map_path=None,
    v_max=None,
    device=None,
    backend=None,
    env=None,
):
    """Launch this CLI as TWO ranks on this machine (a file store for the
    rendezvous) and return rank 0's fleet summary.

    This runs the real multi-process path: the process group, the
    ("host", "chip") mesh and the collectives between processes.
    ``device`` is the ranks' device (the card unless "cpu" is named);
    two ranks share one card only over ``backend="gloo"``. With
    ``full_lap=True`` every scenario drives ``steps`` sequential steps
    through ``sharded_full_lap``.
    """
    with tempfile.TemporaryDirectory() as tmp:
        args = [
            sys.executable, "-m", "acmpc_tpu_torch.cli.launch_pod",
            "--coordinator", f"file://{tmp}/store",
            "--num-hosts", "2",
            "--scenarios-per-chip", str(scenarios_per_chip),
            "--steps", str(steps),
        ]
        if full_lap:
            args.append("--full-lap")
        if map_path is not None:
            args += ["--map", str(map_path)]
        if v_max is not None:
            args += ["--v-max", str(v_max)]
        if device is not None:
            args += ["--device", str(device)]
        if backend is not None:
            args += ["--backend", backend]
        outs = spawn_ranks(
            lambda rank: args + ["--host-id", str(rank)], 2, timeout, env=env
        )
    summaries = [json.loads(line) for line in outs[0].splitlines() if line.startswith("{")]
    if not summaries:
        raise RuntimeError(f"rank 0 printed no summary:\n{outs[0]}")
    return summaries[-1]


def _resolve(path) -> pathlib.Path:
    """A path as given, else relative to the repository root."""
    path = pathlib.Path(path)
    return path if path.exists() else ROOT / path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Pod-sharded closed-loop sweep")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store, or file://<path> on one machine")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="processes in the launch, one rank each")
    ap.add_argument("--host-id", type=int, default=0, help="this process's rank")
    ap.add_argument("--map", default=MAP)
    ap.add_argument("--scenarios-per-chip", type=int, default=SCENARIOS_PER_CHIP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--horizon", type=int, default=HORIZON)
    ap.add_argument("--v-max", type=float, default=V_MAX)
    ap.add_argument(
        "--full-lap",
        action="store_true",
        help="drive every scenario sequentially toward lap completion "
        "(--steps becomes the number of steps) instead of a fixed-step sweep",
    )
    ap.add_argument("--dt", type=float, default=DT)
    ap.add_argument("--device", default=None, help="the ranks' device: cuda (default) or cpu")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="nccl (default on cuda; a card a rank) or gloo (the CPU, "
                    "or ranks that share a card)")
    args = ap.parse_args(argv)
    device = initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_hosts,
        process_id=args.host_id,
        device=args.device,
        backend=args.backend,
    )
    try:
        summary = _run(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if summary is not None:
        print(json.dumps(summary), flush=True)


def _run(args, device) -> dict | None:
    """The sweep on this rank's scenarios; rank 0's summary, else None."""
    sweep = build_sweep(device, args.map, args.horizon)
    tm = sweep.map
    mesh = make_pod_mesh(device=device)
    batch = args.scenarios_per_chip * mesh.size
    grid = put_global(global_grid(batch, tm.n_centre, args.v_max), grid_sharding(mesh))

    summary = {
        "hosts": mesh.shape["host"],
        "chips": mesh.size,
        "mesh": mesh.shape,
        "device": device.type,
        "backend": mesh.backend,
        "scenarios": batch,
        "steps": args.steps,
    }
    if args.full_lap:
        run = sharded_full_lap(sweep, mesh, args.steps, args.dt)
        t0 = time.perf_counter()
        fleet = run(grid)
        laps = int(fleet["completed_laps"])
        wall = time.perf_counter() - t0
        centre = tm.centre
        lap_len = float(torch.linalg.norm(torch.roll(centre, -1, dims=0) - centre, dim=-1).sum())
        summary.update({
            "mode": "full_lap",
            "map_km": round(lap_len / 1000, 2),
            "dt": args.dt,
            "total_solves": int(fleet["n_solves"]),
            "solve_success_rate": round(float(fleet["n_solved"]) / float(fleet["n_solves"]), 4),
            "completed_laps": laps,
            "lap_time_s_mean": (
                round(float(fleet["lap_steps_sum"]) / laps * args.dt, 1) if laps else None
            ),
            "lap_time_s_best": (
                round(float(fleet["lap_steps_min"]) * args.dt, 1) if laps else None
            ),
            "fail_max_iter": int(fleet["fail_max_iter"]),
            "fail_infeasible": int(fleet["fail_infeasible"]),
            "worst_offtrack_m": round(float(fleet["worst_offtrack"]), 2),
            "mean_speed_ms": round(float(fleet["mean_speed"]), 2),
            "wall_s": round(wall, 1),
            "solves_per_s": round(int(fleet["n_solves"]) / wall, 1),
        })
    else:
        run = sharded_lap_sweep(sweep, mesh, args.steps)
        _, fleet = run(grid)  # first use of every shape
        int(fleet["n_solved"])
        t0 = time.perf_counter()
        _, fleet = run(grid)
        n_solved = int(fleet["n_solved"])
        wall = time.perf_counter() - t0
        summary.update({
            "solves_per_s": round(batch * args.steps / wall, 1),
            "success_rate": round(n_solved / float(fleet["n_solves"]), 4),
            "worst_offtrack_m": round(float(fleet["worst_offtrack"]), 2),
            "mean_speed_ms": round(float(fleet["mean_speed"]), 2),
        })
    return summary if mesh.rank == 0 else None


if __name__ == "__main__":
    main()
