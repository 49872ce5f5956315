"""One benchmark cell with the port's monitor on: where its request's time
goes, layer by layer, and what the monitor costs.

    python tools/trace_split.py --workload monza_racing_h50.camera_b1 --seed 7 \
        [--seconds 20] [--cost-seconds 8] [--cost-rounds 2] [--out build/trace_split]

Needs a CUDA card. The cell is built from ``BENCHMARK.json`` as
``perfbench/run.py`` builds it, with ``utils/monitor.MONITOR`` switched
on before its set-up, so that its graphs are captured with their device
spans' timers. Then:

1. an unprofiled stretch of ``--seconds / 2`` with the benchmark's own
   spans on (as a ``--trace 1`` run's first stretch): the program's
   spans and device samples per request, the per-layer numbers of
   ``layer_numbers`` and three sums that bound them;
2. a stretch under ``torch.profiler`` with CUDA activity only (the
   harness's ``_profiled``): every idle gap of the card labelled by the
   benchmark span and the innermost program span that hold its midpoint
   (``label_gaps``), ``<benchmark span>/<program span>``;
3. the monitor's cost: windows of ``--cost-seconds`` with the monitor
   off and on in turns (off, on, on, off, per round), each a p50
   latency, the same cell and seed throughout;
4. the cell's own check of every answer after all of it.

Writes ``<out>/<workload>.json`` and prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def label_gaps(gaps, offset, bench_spans, program_spans) -> dict:
    """Seconds of idle gaps per label. ``gaps`` are (start, end) on the
    device trace's clock, ``offset`` that clock minus the host's;
    ``bench_spans`` (name, start, end) and ``program_spans`` the
    monitor's (name, start, end, parent, request), on the host's. A gap
    is labelled by the benchmark span holding its midpoint ("harness"
    where none does), then ``/<program span>`` by the innermost program
    span holding it (the latest to start, the first to end of those),
    where one does."""
    bench = sorted(bench_spans, key=lambda s: s[1])
    program = sorted(program_spans, key=lambda s: s[1])
    out: dict = collections.defaultdict(float)
    active: list = []
    i = j = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1) - offset
        while i < len(program) and program[i][1] <= mid:
            active.append(program[i])
            i += 1
        active = [s for s in active if s[2] >= mid]
        label = "harness"
        while j + 1 < len(bench) and bench[j + 1][1] <= mid:
            j += 1
        if bench and bench[j][1] <= mid <= bench[j][2]:
            label = bench[j][0]
        if active:
            label += "/" + max(active, key=lambda s: (s[1], -s[2]))[0]
        out[label] += g1 - g0
    return dict(out)


def per_request(taken: dict, n_requests: int) -> dict:
    """Per span name: host ms, device ms, spans and device samples, each
    over ``n_requests`` requests; and the counters as taken."""
    rows: dict = collections.defaultdict(lambda: {"host_ms": 0.0, "device_ms": 0.0, "count": 0, "samples": 0})
    for name, t0, t1, _, _ in taken["spans"]:
        rows[name]["host_ms"] += 1e3 * (t1 - t0)
        rows[name]["count"] += 1
    for name, _, ms in taken["device"]:
        rows[name]["device_ms"] += ms
        rows[name]["samples"] += 1
    n = max(n_requests, 1)
    spans = {name: {k: v / n for k, v in row.items()} for name, row in rows.items()}
    return {"spans": spans, "counters": dict(taken["counters"]), "unresolved": taken["unresolved"]}


def layer_numbers(program: dict, batch: int) -> dict:
    """The per-layer numbers a request, named as the benchmark would
    report them (``.b<batch>`` where the batch is in the name); a number
    whose spans (or, for a device number, their samples) were not
    recorded is left out."""
    spans = program["spans"]

    def total(kind, *names):
        rows = [spans[n] for n in names if n in spans and (kind == "host_ms" or spans[n]["samples"])]
        return sum(r[kind] for r in rows) if len(rows) == len(names) else None

    b = f".b{batch}"
    out = {
        "jpeg_ms": total("host_ms", "perceiver.jpeg_encode", "perceiver.jpeg_decode"),
        "upload_ms": total("host_ms", "perceiver.upload"),
        "segment_device_ms": total("device_ms", "perceiver.segment"),
        "extract_device_ms": total("device_ms", "perceiver.extract"),
        "graph_io_ms" + b: total("host_ms", "graph.inputs", "graph.outputs"),
        "prepare_device_ms" + b: total("device_ms", "mpc.prepare"),
        "factor_device_ms" + b: total("device_ms", "qp.factor"),
        "iterate_device_ms" + b: total("device_ms", "qp.iterate"),
        "lap_device_ms" + b: total("device_ms", "sweep.window", "mpc.shift", "sweep.integrate"),
    }
    out = {k: v for k, v in out.items() if v is not None}
    out["graph_captures"] = sum(v for k, v in program["counters"].items() if k.startswith("graph.capture:"))
    return out


def bounding_sums(numbers: dict, bench_spans: dict, latencies_s: list) -> dict:
    """The sums the per-layer numbers must stay under, each as
    (sum, bound): the host JPEG and upload inside the benchmark's
    perception time, the three device numbers of a B = 1 step inside its
    control time, the four of the B = 256 step inside its wall."""
    mean_ms = lambda xs: 1e3 * statistics.fmean(xs)  # noqa: E731
    out = {}
    if "jpeg_ms" in numbers and "perception" in bench_spans:
        out["jpeg+upload <= perception_ms"] = (
            numbers["jpeg_ms"] + numbers["upload_ms"], mean_ms(bench_spans["perception"]))
    step = [numbers.get(f"{k}_device_ms.b1") for k in ("prepare", "factor", "iterate")]
    if None not in step and "control" in bench_spans:
        out["b1 device <= control_ms.b1"] = (sum(step), mean_ms(bench_spans["control"]))
    sweep = [numbers.get(f"{k}_device_ms.b256") for k in ("prepare", "factor", "iterate", "lap")]
    if None not in sweep:
        out["b256 device <= step wall"] = (sum(sweep), mean_ms(latencies_s))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--cost-seconds", type=float, default=8.0)
    parser.add_argument("--cost-rounds", type=int, default=2)
    parser.add_argument("--out", default=str(ROOT / "build" / "trace_split"))
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench import harness as H  # sets the build caches before CUDA is touched

    import torch

    from acmpc_tpu_torch.utils.monitor import MONITOR

    if not torch.cuda.is_available():
        print("trace_split: needs a CUDA card", file=sys.stderr)
        return 2
    files = H.cell_files(H.load_manifest(), args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(H.HOST_THREADS, torch.get_num_threads()))
    driver = H.load_module(files["driver"], f"perfbench_driver_{files['traffic']['driver']}")
    cell = driver.Cell(files["config"], files["traffic"], args.seed, device)
    MONITOR.enable()
    cell.setup()
    torch.cuda.synchronize()
    batch = cell.shapes()["batch"]
    gc.collect()
    gc.freeze()
    gc.disable()

    # 1. the unprofiled stretch
    MONITOR.clear()
    lat, window_s = H._window(cell, args.seconds / 2, spans=True)
    torch.cuda.synchronize()
    program = per_request(MONITOR.take(), len(lat))
    numbers = layer_numbers(program, batch)
    bench_spans = dict(cell.spans)
    sums = bounding_sums(numbers, bench_spans, lat)

    # 2. the profiled stretch, idle gaps labelled by program spans
    MONITOR.clear()
    stretch = H._profiled(cell, args.seconds / 2)
    taken = MONITOR.take()
    ivs, offset = stretch["intervals"], stretch["offset"]
    t0, t1 = stretch["t0"], stretch["t1"]
    gaps_labelled = None
    if offset is not None:
        ivs = [iv for iv in ivs if iv[2] - offset >= t0 and iv[1] - offset <= t1]
        busy_s, gaps = H.busy_union(ivs)
        gaps_labelled = label_gaps(gaps, offset, stretch["host_spans"], taken["spans"])
        gaps_labelled = dict(sorted(gaps_labelled.items(), key=lambda kv: -kv[1]))
    else:
        busy_s, _ = H.busy_union(ivs)

    # 3. the monitor's cost, off and on in turns
    cost: dict = {"off": [], "on": []}
    for state in ("off", "on", "on", "off") * args.cost_rounds:
        MONITOR.enable() if state == "on" else MONITOR.disable()
        for _ in range(5):  # the first turn in a state captures its graphs
            cell.request()
        torch.cuda.synchronize()
        MONITOR.clear()
        lat_c, _ = H._window(cell, args.cost_seconds, spans=False)
        MONITOR.clear()
        cost[state].append(1e3 * statistics.median(lat_c))
    MONITOR.disable()
    gc.enable()
    gc.unfreeze()

    # 4. the cell's check of every answer
    cell.release()
    checks = cell.check()
    out = {
        "workload": args.workload,
        "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "power_limit": H.power_limit(),
        "correct": H.judged(checks),
        "checks": {name: [v, lim] for name, v, lim in checks},
        "stretch1": {
            "requests": len(lat),
            "window_s": window_s,
            "latency_ms_p50": 1e3 * statistics.median(lat),
            "bench_spans_ms": {k: 1e3 * statistics.fmean(v) for k, v in bench_spans.items()},
            "numbers": numbers,
            "sums": sums,
            "sums_hold": all(s <= b for s, b in sums.values()),
            "program": program,
        },
        "stretch2": {
            "requests": stretch["requests"],
            "profiled_s": t1 - t0,
            "busy_s": busy_s,
            "idle_gaps_s": gaps_labelled,
            "unresolved": taken["unresolved"],
            "graph_captures": sum(v for k, v in taken["counters"].items() if k.startswith("graph.capture:")),
        },
        "cost_p50_ms": cost,
        "cost_on_over_off": statistics.median(cost["on"]) / statistics.median(cost["off"]),
    }
    dest = pathlib.Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.workload}.json").write_text(json.dumps(out, indent=1))
    brief = {k: out[k] for k in ("workload", "correct", "cost_p50_ms", "cost_on_over_off")}
    brief.update(numbers=numbers, sums=sums, unresolved=[program["unresolved"], taken["unresolved"]],
                 idle_gaps_s=dict(list((gaps_labelled or {}).items())[:12]))
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
