"""Full-lap sweep: sequential closed-loop solves around a whole circuit,
a grid of scenarios in parallel, on the card.

Counterpart of ``tools/full_lap.py``. Each step is ``LapSweep.fused_step``
(window extraction, the batched QP, command selection, kinematic
integration); the laps are sequential, every solve warm-started from the
previous step's shifted iterates. Progress is accumulated from map-index
deltas along the sweep's own reference polyline, on the device; the
host reads one flag per step, whether every scenario has lapped.

``--compare-raceline`` also laps the shipped minimum-curvature raceline
with its speed profile, and a centreline grid at a matched cap, and
reports the lap-time ratio of the two.

Run from the root of a checkout:

    python -m acmpc_tpu_torch.bench.full_lap --scenarios 32 --max-steps 12000 \
        [--compare-raceline] [--out result.json]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
from acmpc_tpu_torch.dynamics import SpatialBicycleModel, VehicleParams
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig, SpatialMPC
from acmpc_tpu_torch.qp.admm import STATUS_SOLVED_INACCURATE
from acmpc_tpu_torch.qp.speed_profile import SpeedProfileConstraints

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAP = ROOT / "data" / "maps" / "synth_nordschleife.npy"
RACELINE = ROOT / "data" / "racelines" / "synth_nordschleife.npz"
# the shipped circuit's corridor half width
HALF_WIDTH = 4.5


def closed_loop_mpc(device=None) -> SpatialMPC:
    """The repository's closed-loop operating point (``bench.py``'s
    ``_closed_loop_mpc``): horizon 50, a real-time-iteration budget of 50
    ADMM iterations per solve, speeds 5-30 m/s."""
    constraints = SpeedProfileConstraints(
        v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0,
        ay_max=5.5, ki_min=0.005, end_velocity=10.0,
    )
    config = MPCConfig(
        horizon=50,
        step_cost=(4.0e-3, 5.0e-2, 0.0),
        r_term=(1.0e-2, 10.0),
        final_cost=(1.0, 0.0, 0.1),
        constraints=constraints,
        rti_iterations=50,
    )
    model = SpatialBicycleModel(vehicle=VehicleParams(), min_velocity=5.0, max_velocity=30.0)
    return SpatialMPC(config, model, device=device)


def run_laps(sweep: LapSweep, grid: SweepGrid, dt: float, max_steps: int) -> dict:
    """Drive every scenario to lap completion (or ``max_steps``); returns
    lap statistics."""
    device = sweep.mpc.device
    centre = sweep._centre.detach().cpu().numpy()
    n_pts = len(centre)
    lap_len = float(
        np.linalg.norm(np.diff(np.vstack([centre, centre[:1]]), axis=0), axis=1).sum()
    )
    spacing = lap_len / n_pts
    n_scen = int(grid.start_index.shape[0])

    cars, states, prev_i0 = sweep.start(grid)
    progress = torch.zeros(n_scen, dtype=torch.float64, device=device)
    lap_steps = torch.full((n_scen,), -1, dtype=torch.int64, device=device)
    solves_ok = torch.zeros((), dtype=torch.int64, device=device)
    # unsolved steps by QP status (qp/admm.py STATUS_*)
    codes = torch.arange(STATUS_SOLVED_INACCURATE + 1, device=device)
    fail_status = torch.zeros(len(codes), dtype=torch.int64, device=device)

    t0 = time.perf_counter()
    step = 0
    while step < max_steps and bool((lap_steps < 0).any()):
        cars, states, metrics, i0 = sweep.fused_step(cars, states, grid.v_max, prev_i0)
        delta = torch.remainder(i0 - prev_i0, n_pts)
        # windows only move forward; a large residual is wraparound noise
        delta = torch.where(delta > n_pts // 2, 0, delta)
        progress += delta.double() * spacing
        newly = (lap_steps < 0) & (progress >= lap_len)
        lap_steps = torch.where(newly, step + 1, lap_steps)
        solved = metrics["solved"]
        solves_ok += solved.sum()
        fail_status += (
            (metrics["control_status"][:, None] == codes) & ~solved[:, None]
        ).sum(dim=0)
        prev_i0 = i0
        step += 1
    lap_steps = lap_steps.cpu().numpy()
    solves_ok = int(solves_ok)
    fail_status = fail_status.cpu().numpy()
    wall = time.perf_counter() - t0

    total = n_scen * step
    done = lap_steps > 0
    lap_times = lap_steps[done] * dt
    return {
        "map_km": round(lap_len / 1000, 2),
        "scenarios": n_scen,
        "completed_laps": int(done.sum()),
        "sequential_solves_per_scenario": step,
        "total_solves": total,
        "solve_success_rate": round(solves_ok / max(total, 1), 4),
        # 0 = iteration budget, 2 = primal infeasibility certificate
        # (keep-last-command semantics)
        "failure_status_histogram": {
            str(k): int(v) for k, v in enumerate(fail_status) if v > 0
        },
        "lap_time_s_best": round(float(lap_times.min()), 1) if done.any() else None,
        "lap_time_s_mean": round(float(lap_times.mean()), 1) if done.any() else None,
        "mean_lap_speed_ms": (
            round(float(lap_len / lap_times.mean()), 2) if done.any() else None
        ),
        "wall_s": round(wall, 1),
        "closed_loop_solves_per_s": round(total / wall, 1),
    }


def raceline_sweep(mpc: SpatialMPC, track_map, grid: SweepGrid, dt: float, path=RACELINE):
    """The sweep that tracks the shipped raceline with its widths and
    speed profile, and its grid: the same starts scaled onto the
    raceline's points, on the line, capped by the profile (grid cap 32)."""
    with np.load(path) as data:
        line, widths, speeds = data["raceline"], data["widths"], data["speeds"]
    sweep = LapSweep(
        mpc, track_map, half_width=HALF_WIDTH, dt=dt,
        reference_polyline=line, reference_widths=widths, reference_speeds=speeds,
    )
    scale = len(line) / track_map.n_centre
    rgrid = dataclasses.replace(
        grid,
        start_index=(grid.start_index.float() * scale).long(),
        # its corridor can leave < 1 m of play
        lateral_offset=torch.zeros_like(grid.lateral_offset),
        v_max=torch.full_like(grid.v_max, 32.0),
    )
    return sweep, rgrid


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--map", default=str(MAP))
    ap.add_argument("--raceline", default=str(RACELINE))
    ap.add_argument("--scenarios", type=int, default=32)
    ap.add_argument("--v-max", type=float, default=24.0)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--max-steps", type=int, default=12000)
    ap.add_argument(
        "--compare-raceline",
        action="store_true",
        help="also lap the shipped raceline + speed profile; report the lap-time comparison",
    )
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    mpc = closed_loop_mpc()
    tm = load_track_map(args.map)
    g = torch.Generator(device=mpc.device).manual_seed(0)
    grid = SweepGrid.perturbed(g, args.scenarios, tm.n_centre, v_max=args.v_max)
    sweep = LapSweep(mpc, tm, half_width=HALF_WIDTH, dt=args.dt)
    out = {"kind": torch.cuda.get_device_name(mpc.device)}
    out.update(run_laps(sweep, grid, args.dt, args.max_steps))

    if args.compare_raceline:
        rsweep, rgrid = raceline_sweep(mpc, tm, grid, args.dt, args.raceline)
        r = run_laps(rsweep, rgrid, args.dt, args.max_steps)
        out["raceline"] = r
        # matched-cap centreline laps (cap 30), so the ratio compares
        # lines, not speed caps
        cgrid = dataclasses.replace(
            grid,
            lateral_offset=torch.zeros_like(grid.lateral_offset),
            v_max=torch.full_like(grid.v_max, 30.0),
        )
        c = run_laps(sweep, cgrid, args.dt, args.max_steps)
        out["centreline_at_vmax30"] = c
        if r["lap_time_s_mean"] and c["lap_time_s_mean"]:
            # < 1.0: the raceline laps faster
            out["raceline_lap_time_ratio"] = round(
                r["lap_time_s_mean"] / c["lap_time_s_mean"], 4
            )

    line = json.dumps(out)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
