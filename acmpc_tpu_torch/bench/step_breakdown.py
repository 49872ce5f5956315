"""Where the time of one warm batched MPC step goes on the card.

    python -m acmpc_tpu_torch.bench.step_breakdown [--batch 256] [--steps 5]

The monza racing config at horizon 50 on the difficulty-ramp windows of
chip_smoke.py, stepped warm (each step starts from the previous carry).
Prints one JSON line with:
  * the host-clock ms of a step and of its three layers (prepare: waypoints,
    speed profile and QP assembly; solve: the batched ADMM engine; extract),
    each ended by a device synchronise, median over ``--steps``;
  * the solver's chunk count per step;
  * from ``torch.profiler`` over ``--steps`` more steps, run without those
    synchronisations: device time by kernel name (top 12), the device's
    busy time and its idle share of the wall.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _layers(mpc, states, refs):
    """One step of ``batched_get_control_fused``, cut into its layers;
    returns (new states, diagnostics, seconds per layer)."""
    from acmpc_tpu_torch.qp.batched import solve_box_qp_batched

    B = refs.shape[0]
    seconds = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    v_max = torch.full((B,), mpc.config.constraints.v_max, device=refs.device)
    flags = torch.zeros((B,), dtype=torch.bool, device=refs.device)
    offsets = torch.zeros((B,), device=refs.device)
    path, speed, qp = timed(
        "prepare", lambda: mpc._prepare(states, refs, v_max, flags, offsets)
    )
    sol = timed(
        "solve",
        lambda: solve_box_qp_batched(*qp, mpc.admm, x0=states.qp_x, y0=states.qp_y),
    )
    new, diags = timed("extract", lambda: mpc._extract(states, path, speed, sol))
    return new, diags, seconds


def device_time(prof, exclude=()):
    """Device-side events of a ``torch.profiler`` run (kernels, copies,
    sets; CPU ops and record_function ranges also carry device time and
    would count twice), less those named in ``exclude`` (the device-side
    copies of record_function ranges): the busy microseconds, the union
    of their intervals, and {name: [microseconds, count]}."""
    per_kernel: dict[str, list] = {}
    intervals = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.name in exclude:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        row = per_kernel.setdefault(evt.name, [0.0, 0])
        row[0] += end - start
        row[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us, per_kernel


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_breakdown: no CUDA device is available", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from chip_smoke import difficulty_ramp, make_mpc

    mpc = make_mpc("monza", "cuda")
    refs = torch.as_tensor(difficulty_ramp(50, args.batch), device="cuda")
    states, _ = mpc.batched_get_control_fused(mpc.initial_state(args.batch), refs)
    states, _ = mpc.batched_get_control_fused(states, refs)

    rows, chunks = [], []
    for _ in range(args.steps):
        states, diags, seconds = _layers(mpc, states, refs)
        rows.append(seconds)
        chunks.append(int(diags.control_iterations.max()) // mpc.admm.check_every)
    layer_ms = {k: 1e3 * float(np.median([r[k] for r in rows])) for k in rows[0]}

    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    # the profiled steps run as a caller runs them, without the layer
    # timer's synchronisations
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            states, _ = mpc.batched_get_control_fused(states, refs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)

    busy_us, per_kernel = device_time(prof)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card,
        "batch": args.batch,
        "steps": args.steps,
        "step_ms": sum(layer_ms.values()),
        "layer_ms": layer_ms,
        "chunks_per_step": chunks,
        "profiled_wall_ms_per_step": wall_us / 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "top_kernels_ms_per_step": [
            {"name": name[:90], "ms": us / 1e3 / args.steps, "calls_per_step": n / args.steps}
            for name, (us, n) in kernels[:12]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
