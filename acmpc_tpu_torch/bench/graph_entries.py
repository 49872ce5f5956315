"""The compiled entries on the card against their eager forms.

``SpatialMPC.jitted_get_control`` (one CUDA graph a step, the QP's chunk
loop a WHILE node in it) against ``get_control``, and the perceiver's
captured pipeline (``Perceiver._pipeline``) against ``_run_pipeline``,
on the same inputs in one process:

* ``closed_loop``: B = 1 closed-loop steps on the monza map
  (``bench/lap_sweep.LapSweep``'s window, warm-start shift and
  kinematic car), the state carried, once through each entry; every
  step's ``MPCState`` and diagnostics and the window indices must be
  bit-equal. Two steps take an injected window: an 1,006 m hairpin of
  ``bench/batch_sweep.mixed_refs`` (both packages leave it unsolved,
  ``tests/test_torch_batch_sweep.py``; the solve certifies it primal
  infeasible) and a gentle curve shrunk to a twentieth (waypoints about
  5 cm apart), whose solve runs to ``max_iter``.
* ``timed_steps``: the warm B = 1 step on one window, eager and captured
  in turns (250 steps a block, two blocks each), with the process on
  fixed CPU cores: wall p50/p99 (host clock to a synchronise), host
  synchronisations a step (``torch.cuda.set_sync_debug_mode("warn")``),
  launches and busy time a step (``torch.profiler``), chunks a step, the
  capture's time and the graph's memory pool.
* ``timed_frames``: the same for the perceiver's frame at 1280x736 bf16.
* ``loop_row``: a ``device_while`` whose body is one add, per trip,
  captured against eager (the loop kernel's row of ``chip_smoke.py``).

    python -m acmpc_tpu_torch.bench.graph_entries [--steps 200] [--timed 250]

prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np
import torch

from acmpc_tpu_torch.bench import batch_sweep
from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.dynamics import SpatialBicycleModel
from acmpc_tpu_torch.geometry.tracks import get_curved_track, with_widths
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mpc.spatial_mpc import MPCDiagnostics, MPCState, SpatialMPC, shift_warm_start
from acmpc_tpu_torch.ops import graph_loop
from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, admm_chunk
from acmpc_tpu_torch.ops.track_chain import chain_edges

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAP = ROOT / "data" / "maps" / "monza.npz"
STEPS = 200
TIMED = 250  # steps (or frames) a block; two blocks of each entry
PROFILED = 20
# injected windows: the 1,006 m hairpin (mixed_refs at B = 1,024, i =
# 1,000), and a curve of curvature 0.02 scaled by SHRINK
HAIRPIN_INDEX = 1000
SHRINK = 0.05
# the CPU cores the timed blocks run on
CORES = 2


def make_mpc(mode: str, device=None) -> SpatialMPC:
    """monza's racing control cut to horizon 50, or its mapping control
    as configured (horizon 100)."""
    if mode == "racing":
        return batch_sweep.make_mpc(50, device)
    control = load_config(ROOT / "configs" / "monza.yaml").mapping_control
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle,
        min_velocity=control.constraints.v_min,
        max_velocity=control.constraints.v_max,
    )
    return SpatialMPC(control, model, device=device)


def hard_windows(horizon: int, device) -> dict:
    """{name: (horizon, 3) window}: the unsolved hairpin and the shrunk
    curve that runs to ``max_iter``."""
    hairpin = batch_sweep.mixed_refs(horizon, 1024)[HAIRPIN_INDEX]
    shrunk = with_widths(get_curved_track(0.01, horizon, angle=-np.pi / 2)).astype(np.float32)
    shrunk[:, :2] *= SHRINK
    return {
        "hairpin_r1006": torch.as_tensor(hairpin, device=device),
        "shrunk": torch.as_tensor(shrunk, device=device),
    }


def closed_loop(mpc: SpatialMPC, get_control, n_steps: int, inject: dict, track_map) -> list:
    """``n_steps`` closed-loop steps of one car from the map's first
    point, each through ``get_control``; ``inject`` {step: window}
    replaces that step's window. Returns [(state, diags, window index)]
    per step, on the device."""
    device = mpc.device
    sweep = LapSweep(mpc, track_map, half_width=5.0, dt=0.1)
    grid = SweepGrid(
        start_index=torch.zeros((), dtype=torch.int64, device=device),
        lateral_offset=torch.zeros((), device=device),
        v_max=torch.full((), mpc.config.constraints.v_max, device=device),
    )
    car = sweep._init_car(grid)
    state = mpc.initial_state()
    _, prev_i0 = sweep._ego_window(car)
    records = []
    for k in range(n_steps):
        ref, i0 = sweep._ego_window(car)
        ref = inject.get(k, ref)
        state = shift_warm_start(state, sweep._shift_stages(i0, prev_i0), mpc.horizon)
        state, diags = get_control(state, ref, grid.v_max)
        car, _ = sweep._integrate(car, state, i0)
        records.append((state, diags, i0))
        prev_i0 = i0
    return records


def clear_launches() -> None:
    """Every counted kernel's launches set to 0 (the replays' settled
    first)."""
    graph_loop.settle_launches()
    admm_chunk.launches.clear()
    chain_edges.launches.clear()
    graph_loop.device_while.launches.clear()


def counted_launches() -> dict:
    """The launches counted since :func:`clear_launches`, by kernel."""
    graph_loop.settle_launches()
    counts = {**admm_chunk.launches, **chain_edges.launches, **graph_loop.device_while.launches}
    return {name: n for name, n in counts.items() if n}


def _fields(record) -> dict:
    state, diags, i0 = record
    out = {f"state.{f.name}": getattr(state, f.name) for f in dataclasses.fields(MPCState)}
    out.update({f"diags.{f.name}": getattr(diags, f.name) for f in dataclasses.fields(MPCDiagnostics)})
    out["window_index"] = i0
    return out


def compare_loops(mode: str, n_steps: int = STEPS, device="cuda") -> dict:
    """The closed loop through ``get_control`` and through
    ``jitted_get_control`` (each from a fresh MPC and the same start);
    every step's fields must be bit-equal."""
    track_map = load_track_map(MAP, device)
    runs, launches = {}, {}
    for name in ("eager", "captured"):
        mpc = make_mpc(mode, device)
        windows = hard_windows(mpc.horizon, device)
        inject = {n_steps // 3: windows["hairpin_r1006"], 2 * n_steps // 3: windows["shrunk"]}
        entry = mpc.get_control if name == "eager" else mpc.jitted_get_control
        clear_launches()
        runs[name] = closed_loop(mpc, entry, n_steps, inject, track_map)
        launches[name] = counted_launches()
    torch.cuda.synchronize()
    mismatches = []
    for k, (a, b) in enumerate(zip(runs["eager"], runs["captured"])):
        fa, fb = _fields(a), _fields(b)
        for key in fa:
            if not torch.equal(fa[key], fb[key]):
                mismatches.append(f"step {k}: {key}")
    diags = [r[1] for r in runs["captured"]]
    iterations = [int(d.control_iterations) for d in diags]
    chunks = [it // mpc.admm.check_every for it in iterations]
    # every chunk a launch of the cluster kernel; the captured run's first
    # step also ran once eagerly (the capture's warm-up), and its loop
    # kernel runs once a step on entry and once a chunk
    expected = {
        "eager": {CLUSTER_BOX: sum(chunks)},
        "captured": {CLUSTER_BOX: sum(chunks) + chunks[0], graph_loop.SET_CONDITION: n_steps + sum(chunks)},
    }
    status = [int(d.control_status) for d in diags]
    solved = [bool(r[0].solved) for r in runs["captured"]]
    check_every = mpc.admm.check_every
    return {
        "mode": mode,
        "horizon": mpc.horizon,
        "steps": n_steps,
        "bit_equal": not mismatches,
        "mismatches": mismatches[:10],
        "launches": launches,
        "launches_expected": expected,
        "injected": {str(k): name for k, name in zip(inject, ("hairpin_r1006", "shrunk"))},
        "injected_status": [status[k] for k in inject],
        "injected_iterations": [iterations[k] for k in inject],
        "max_iter_exits": sum(it >= mpc.admm.max_iter for it in iterations),
        "unsolved_steps": solved.count(False),
        "chunks_per_step": {
            "mean": float(np.mean(iterations)) / check_every,
            "max": max(iterations) // check_every,
        },
        "window_index_last": int(runs["captured"][-1][2]),
    }


@contextlib.contextmanager
def pinned_cores(n: int = CORES):
    """The process on its first ``n`` allowed CPU cores for the block."""
    before = os.sched_getaffinity(0)
    os.sched_setaffinity(0, sorted(before)[:n])
    try:
        yield sorted(os.sched_getaffinity(0))
    finally:
        os.sched_setaffinity(0, before)


def count_syncs(fn, n: int) -> float:
    """Host synchronisations a call of ``fn`` (the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` over ``n`` calls)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n):
                fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught) / n


def _profile(fn, n: int) -> dict:
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_kernel = device_time(prof)
    return {
        "device_busy_ms": busy_us / 1e3 / n if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "device_ops_per_call": sum(c for _, c in per_kernel.values()) / n,
        "profiled_wall_ms": wall_us / 1e3 / n,
    }


def _percentiles(ms: list) -> dict:
    return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)), "n": len(ms)}


def _pool_bytes(graph) -> int:
    """Bytes of the segments of ``graph``'s private memory pool."""
    pool = tuple(graph.graph.pool())
    return sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if tuple(seg.get("segment_pool_id", ())) == pool
    )


def _in_turns(calls: dict, n: int) -> dict:
    """Each of ``calls`` (name -> no-argument callable) ``n`` times a
    block, in the order a, b, b, a; wall ms per call to a synchronise."""
    times = {name: [] for name in calls}
    names = list(calls)
    for name in names + names[::-1]:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return times


def timed_steps(mode: str, n: int = TIMED, device="cuda") -> dict:
    """The warm B = 1 step on one window, eager against captured."""
    mpc = make_mpc(mode, device)
    ref = torch.as_tensor(batch_sweep.mixed_refs(mpc.horizon, 1)[0], device=device)
    v_max = torch.full((), mpc.config.constraints.v_max, device=device)
    states = {"eager": mpc.initial_state(), "captured": mpc.initial_state()}
    entries = {"eager": mpc.get_control, "captured": mpc.jitted_get_control}
    diags = {}

    def step(name):
        states[name], diags[name] = entries[name](states[name], ref, v_max)

    step("eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step("captured")  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph = next(iter(mpc.jitted_get_control.graphs.graphs.values()))
    with pinned_cores() as cores:
        times = _in_turns({k: (lambda k=k: step(k)) for k in entries}, n)
        out = {}
        for name in entries:
            out[name] = {
                "wall_ms": _percentiles(times[name]),
                "host_syncs_per_step": count_syncs(lambda: step(name), 20),
                **_profile(lambda: step(name), PROFILED),
                "chunks_per_step": int(diags[name].control_iterations) / mpc.admm.check_every,
                "solved": bool(states[name].solved),
            }
    graph_loop.settle_launches()
    out["captured"]["capture_s"] = capture_s
    out["captured"]["pool_bytes"] = _pool_bytes(graph)
    out["cores"] = cores
    out["mode"] = mode
    out["horizon"] = mpc.horizon
    return out


def timed_frames(perc, frames: list, n: int = TIMED) -> dict:
    """The perceiver's frame, eager ``_run_pipeline`` against the
    captured ``_pipeline``, on device frames taken in turn."""
    index = {"eager": 0, "captured": 0}
    entries = {"eager": perc._run_pipeline, "captured": perc._pipeline}

    def frame(name):
        i = index[name] = (index[name] + 1) % len(frames)
        return entries[name](frames[i])

    frame("eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame("captured")
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with pinned_cores() as cores:
        times = _in_turns({k: (lambda k=k: frame(k)) for k in entries}, n)
        out = {
            name: {
                "wall_ms": _percentiles(times[name]),
                "host_syncs_per_frame": count_syncs(lambda: frame(name), 20),
                **_profile(lambda: frame(name), PROFILED),
            }
            for name in entries
        }
    out["captured"]["capture_s"] = capture_s
    out["cores"] = cores
    return out


def compare_frames(perc, frames: list) -> dict:
    """The captured pipeline against eager on each frame: the mask, the
    semantics and every polyline and edge tensor bit-equal."""
    mismatches = []
    for i, image in enumerate(frames):
        d0, s0, t0 = perc._run_pipeline(image)
        d1, s1, t1 = perc._pipeline(image)
        pairs = {"drivable": (d0, d1), "semantics": (s0, s1), **{k: (t0[k], t1[k]) for k in t0}}
        mismatches += [f"frame {i}: {k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    return {"frames": len(frames), "bit_equal": not mismatches, "mismatches": mismatches[:10]}


def _count_to(start, limit):
    """``start`` counted up to ``limit`` by ``device_while``, one a trip."""
    def cond(carry):
        return carry[0] < limit

    def body(carry):
        return (carry[0] + 1,)

    return list(graph_loop.device_while(cond, body, (start,)))


def loop_row(trips: int = 1000, device="cuda") -> dict:
    """The loop kernel's row: ms a trip of :func:`_count_to` captured and
    eager, the kernel's launches in one replay (one a trip and one on
    entry) and |expected - counted| of the count and the launches."""
    start = torch.zeros((), dtype=torch.int32, device=device)
    limit = torch.full((), trips, dtype=torch.int32, device=device)
    graph = graph_loop.CapturedGraph(_count_to, [start, limit], "device_while(count)")
    clear_launches()
    (end,) = graph([start, limit])
    launches = counted_launches().get(graph_loop.SET_CONDITION, 0)
    err = abs(int(end) - trips) + abs(launches - (trips + 1))

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps / trips

    return {
        "trips": trips,
        "launches": launches,
        "max_abs_err": err,
        "ms_per_trip": timed(lambda: graph([start, limit])),
        "plain_ms_per_trip": timed(lambda: _count_to(start, limit)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--timed", type=int, default=TIMED)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("graph_entries: no CUDA device is available", file=sys.stderr)
        return 2
    out = {"kind": torch.cuda.get_device_name(0), "cuda": graph_loop.cuda_versions()}
    out["loop"] = loop_row()
    for mode in ("racing", "mapping"):
        out[f"{mode}_loop"] = compare_loops(mode, args.steps)
        out[f"{mode}_timed"] = timed_steps(mode, args.timed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
