"""Where the time of one closed-loop lap-sweep step goes on the card.

    python -m acmpc_tpu_torch.bench.lap_step [--batch 256] [--steps 25]

The repository's closed-loop operating point (``full_lap.closed_loop_mpc``:
horizon 50, a real-time-iteration budget of 50 ADMM iterations) on the
shipped synth_nordschleife map, ``--batch`` perturbed scenarios (seed 0,
cap 24 m/s). Prints one JSON line with:
  * the host-clock ms of each step's three pieces, each ended by a device
    synchronise: the window (argmin over the reference polyline, the
    warm-start shift, the runtime cap), the MPC step
    (``batched_get_control_fused``) and the integration (command
    selection, the kinematic car, the off-track argmin); medians over
    ``--steps``;
  * the wall of ``LapSweep.run_fused`` over ``--steps`` steps and its
    closed-loop solves/s;
  * from ``torch.profiler`` over that many more ``run_fused`` steps:
    device time by kernel name (top 12), the device's busy time and its
    idle share of the wall.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from acmpc_tpu_torch.bench.full_lap import HALF_WIDTH, MAP, closed_loop_mpc
from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mpc.spatial_mpc import shift_warm_start


def split_steps(sweep: LapSweep, grid: SweepGrid, n_steps: int):
    """``n_steps`` closed-loop steps from the grid's start, cut into
    window, MPC step and integration, each ended by a synchronise.
    Returns ({piece: [ms per step]}, the first step's (cars, states,
    prev_i0) before it and (states, metrics, i0) after it)."""
    mpc = sweep.mpc
    split = {"window_ms": [], "mpc_ms": [], "integrate_ms": []}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key].append(1e3 * (time.perf_counter() - t0))
        return out

    cars, states, prev = sweep.start(grid)
    localised = torch.full(prev.shape, sweep._speeds is not None, device=prev.device)
    first = None
    for _ in range(n_steps):
        before = (cars, states, prev)

        def window():
            refs, i0 = sweep._ego_window(cars)
            shifted = shift_warm_start(states, sweep._shift_stages(i0, prev), mpc.horizon)
            return refs, i0, shifted, sweep._runtime_v_max(grid.v_max, i0)

        refs, i0, states, v_cap = timed("window_ms", window)
        states, _ = timed(
            "mpc_ms",
            lambda: mpc.batched_get_control_fused(states, refs, v_max=v_cap, is_localised=localised),
        )
        cars, metrics = timed("integrate_ms", lambda: sweep._integrate(cars, states, i0))
        prev = i0
        if first is None:
            first = (before, (states, metrics, i0))
    return split, first


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lap_step: no CUDA device is available", file=sys.stderr)
        return 2

    mpc = closed_loop_mpc("cuda")
    tm = load_track_map(MAP, device="cuda")
    sweep = LapSweep(mpc, tm, half_width=HALF_WIDTH)
    g = torch.Generator(device="cuda").manual_seed(0)
    grid = SweepGrid.perturbed(g, args.batch, tm.n_centre, v_max=24.0)
    sweep.run_fused(grid, args.steps)  # first use of every shape

    split, _ = split_steps(sweep, grid, args.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = sweep.run_fused(grid, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sweep.run_fused(grid, args.steps)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    busy_us, per_kernel = device_time(prof)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    step_ms = [sum(parts) for parts in zip(*split.values())]
    print(json.dumps({
        "card": card,
        "batch": args.batch,
        "steps": args.steps,
        "split_step_ms_median": float(np.median(step_ms)),
        **{f"{k}_median": float(np.median(v)) for k, v in split.items()},
        "run_fused_ms_per_step": 1e3 * wall / args.steps,
        "closed_loop_solves_per_s": args.batch * args.steps / wall,
        "solve_success_rate": float(metrics["solved"].float().mean()),
        "profiled_wall_ms_per_step": wall_us / 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "kernels_per_step": sum(n for _, n in per_kernel.values()) / args.steps,
        "top_kernels_ms_per_step": [
            {"name": name[:90], "ms": us / 1e3 / args.steps, "calls_per_step": n / args.steps}
            for name, (us, n) in kernels[:12]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
