"""The benchmark's run of one cell: find the cell's files by name, set up
the program, warm it, measure for a fixed window, read the metrics,
check the answers against the plain reference, print one result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell owns is a file found by its name in ``BENCHMARK.json``:
the configuration (``configs/<config>.json``), the traffic
(``traffic/<traffic>.json``, whose ``driver`` key names the request
generator in ``drivers/<driver>.py``) and each metric
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number, or
None where the cell has nothing for it to read).

A run with ``--trace 0`` reports the cell's end-to-end metrics. One
with ``--trace 1`` measures the same requests in two stretches: one
with the benchmark's own spans and the program's launch counters, and
one under ``torch.profiler`` with CUDA activity only, whose busy time
inside the requests is set against the wall of the first stretch; it
reports the per-layer metrics and a breakdown of device time and idle
gaps.

``setup_s`` runs from the start of the process to the first timed
request, a checkout's first build of the port's CUDA libraries included;
``build_s``, beside it in the result line, is the CPU time of the
compilers that set-up ran (the child processes), so that the build is
recorded apart. Python's collector is frozen and off in the window.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import pathlib
import resource
import subprocess
import sys
import time

T_PROCESS = time.perf_counter()
BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths, before CUDA or a compiler is first touched
for _var, _dir in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "build" / _dir)
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "acmpc_tpu")
PROFILED_REQUESTS = 200  # at most, in a traced run's profiled stretch
HOST_THREADS = 4  # torch's CPU threads: one process with few threads


class NoCard(RuntimeError):
    pass


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(manifest: dict, workload: str, root: pathlib.Path = ROOT) -> dict:
    """The named cell's entry, its configuration and traffic (parsed), its
    driver module's path and its metrics (entry, path), end-to-end first.
    Raises KeyError for a name the manifest lacks."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    bench = root / "perfbench"
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            if workload in m.get("workloads", [workload]):
                metrics.append((kind, m, bench / "metrics" / f"{m['name']}.py"))
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "driver": bench / "drivers" / f"{traffic['driver']}.py",
        "metrics": metrics,
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
        return done.stdout.strip().splitlines()[0] if done.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_intervals(prof) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of every device activity (kernels, copies,
    sets) the profiler recorded."""
    import torch

    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.start * 1e-6, evt.time_range.end * 1e-6))
    return out


def busy_union(intervals) -> tuple[float, list[tuple[float, float]]]:
    """The union length of the intervals (device busy seconds), and the
    idle gaps between them as (start, end)."""
    busy, reach, gaps = 0.0, None, []
    for _, start, end in sorted(intervals, key=lambda t: t[1]):
        if reach is None:
            busy, reach = end - start, end
        elif end > reach:
            if start > reach:
                gaps.append((reach, start))
            busy += end - max(start, reach)
            reach = end
    return busy, gaps


def children_cpu_s() -> float:
    """CPU seconds of the child processes this process has waited for
    (the compilers a build runs)."""
    use = resource.getrusage(resource.RUSAGE_CHILDREN)
    return use.ru_utime + use.ru_stime


def judged(checks) -> bool:
    """``correct``: some number was compared, and each is finite and
    within its limit."""
    import math

    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def _window(cell, seconds: float, spans: bool):
    """Closed-loop requests for ``seconds``: the latencies (s) and the
    window's wall from its first request to the end of its last."""
    cell.spans = {} if spans else None
    lat = []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        lat.append(cell.request())
        now = time.perf_counter()
        if now >= t_end:
            break
    return lat, now - t0


def _profiled(cell, seconds: float):
    """The traced stretch: requests under torch.profiler with CUDA
    activity only, with host spans on the perf_counter clock. A marker
    launch after a synchronise ties the two clocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = []
    cell.host_spans = spans
    n = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while n < PROFILED_REQUESTS:
            cell.request()
            n += 1
            if time.perf_counter() >= t_end:
                break
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    cell.host_spans = None
    ivs = device_intervals(prof)
    marks = [s for name, s, _ in ivs if "spin" in name or "sleep" in name]
    offset = (min(marks) - t_mark) if marks else None
    ivs = [iv for iv in ivs if not ("spin" in iv[0] or "sleep" in iv[0])]
    return {"intervals": ivs, "offset": offset, "host_spans": spans, "requests": n,
            "t0": t0, "t1": t1}


def overlap(segments, spans) -> float:
    """Seconds that two lists of disjoint (start, end) segments, each
    sorted by start, share."""
    total, j = 0.0, 0
    for s0, s1 in segments:
        while j < len(spans) and spans[j][1] <= s0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < s1:
            total += min(s1, spans[k][1]) - max(s0, spans[k][0])
            k += 1
    return total


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) spans as disjoint sorted segments."""
    out: list[list[float]] = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return [(a, b) for a, b in out]


def busy_segments(intervals) -> list[tuple[float, float]]:
    return merged([(s, e) for _, s, e in intervals])


def _breakdown(prof_stretch) -> tuple[dict, float, float, float | None]:
    """The breakdown, the device's busy seconds in the stretch, the
    stretch's length, and the busy seconds inside the requests' host spans
    (None where the clocks could not be tied): the program's device time,
    without the benchmark's own work between requests."""
    ivs = prof_stretch["intervals"]
    offset = prof_stretch["offset"]
    t0, t1 = prof_stretch["t0"], prof_stretch["t1"]
    if offset is not None:  # keep what falls inside the requests' stretch
        ivs = [iv for iv in ivs if iv[2] - offset >= t0 and iv[1] - offset <= t1]
    busy, gaps = busy_union(ivs)
    in_requests = None
    if offset is not None:
        spans = merged([(s0 + offset, s1 + offset) for _, s0, s1 in prof_stretch["host_spans"]])
        in_requests = overlap(busy_segments(ivs), spans)
    per_op: dict[str, float] = {}
    for name, s, e in ivs:
        per_op[name] = per_op.get(name, 0.0) + (e - s)
    idle: dict[str, float] = {}
    if offset is not None:
        spans = sorted(prof_stretch["host_spans"], key=lambda t: t[1])
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1) - offset
            label = "harness"
            for name, s0, s1 in spans:
                if s0 <= mid <= s1:
                    label = name
            idle[label] = idle.get(label, 0.0) + (g1 - g0)
    top = lambda d: sorted(([k[:160], v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {"device_ops": top(per_op), "idle_gaps": top(idle)}, busy, t1 - t0, in_requests


def run(workload: str, seed: int, seconds: float, trace: bool, root: pathlib.Path = ROOT,
        require_card: bool = True, device=None, cell_hook=None, control: bool = False):
    """One run of one cell; returns (the result object, the compared
    numbers [(name, value, limit)]). ``require_card`` False and a
    ``device`` run it elsewhere (the tests); ``cell_hook(cell)`` may alter
    the set-up cell before the window (the tests' planted faults);
    ``control`` adds a third item, the control's numbers on the same
    inputs with the same limits [(name, value, limit)], which ``judged``
    has to find not correct (``calibrate.py``)."""
    import torch

    files = cell_files(load_manifest(root), workload, root)
    build0 = children_cpu_s()
    chips = files["cell"]["chips"]
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(HOST_THREADS, torch.get_num_threads()))
    driver = load_module(files["driver"], f"perfbench_driver_{files['traffic']['driver']}")
    cell = driver.Cell(files["config"], files["traffic"], seed, device)
    cell.setup()
    if cell_hook is not None:
        cell_hook(cell)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_PROCESS
    build_s = children_cpu_s() - build0
    ctx = {"setup_s": setup_s, "cell": cell, "trace": None}
    gc.collect()
    gc.freeze()
    gc.disable()
    if not trace:
        lat, window_s = _window(cell, seconds, spans=False)
        ctx.update(latencies_s=lat, window_s=window_s)
    else:
        counters0 = cell.counters()
        lat, window_s = _window(cell, seconds / 2, spans=True)
        counters1 = cell.counters()
        stretch = _profiled(cell, seconds / 2)
        breakdown, busy_s, prof_s, request_busy_s = _breakdown(stretch)
        ctx.update(latencies_s=lat, window_s=window_s, trace={
            "spans": cell.spans, "requests": len(lat),
            "counters": {k: counters1.get(k, 0) - counters0.get(k, 0) for k in counters1},
            "kernels": _kernel_table(stretch["intervals"]),
            "busy_s": busy_s, "request_busy_s": request_busy_s, "profiled_s": prof_s,
            "profiled_requests": stretch["requests"],
        })
    gc.enable()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    metrics = {}
    for kind, entry, path in files["metrics"]:
        if (kind == "per_layer") != trace:
            continue
        value = load_module(path, "perfbench_metric_" + entry["name"].replace(".", "_")).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    out = {
        "correct": judged(checks),
        "attempted": int(cell.attempted()),
        "failed": int(cell.failed()),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
            "count": chips,
            "memory_peak_bytes": int(peak),
        },
    }
    out["build_s"] = build_s
    if trace:
        out["device"].update(busy_s=busy_s, window_s=prof_s)
        out["breakdown"] = breakdown
    if control:
        limits = {name: lim for name, _, lim in checks}
        return out, checks, [(name, v, limits[name]) for name, v in cell.control()]
    return out, checks


def _kernel_table(intervals) -> dict:
    table: dict[str, list] = {}
    for name, s, e in intervals:
        row = table.setdefault(name, [0.0, 0])
        row[0] += e - s
        row[1] += 1
    return table


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        out, checks = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 2
    except ImportError as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return 3
    import torch

    out["power_limit"] = power_limit() if torch.cuda.is_available() else "none"
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(f"build_s: {out['build_s']!r} (the compilers' CPU seconds in set-up)", file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
