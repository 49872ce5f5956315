"""Replay the committed localisation recordings through the port's filter.

Counterpart of ``tools/record_locbench.py --replay-only``: each recording
under ``data/localisation/<track>_<source>/racing`` goes through
``BenchmarkLocalisation`` with its track's shipped config and map
(``configs/<track>.yaml``, ``data/maps/<track>.npz``) and a filter seed.

    python -m acmpc_tpu_torch.bench.locbench --all [--profile]
    python -m acmpc_tpu_torch.bench.locbench --recordings monza_synth \\
        --seeds 0 1 2 --max-steps 2000 [--device cpu]

Prints one JSON line per replay: the tracker's summary (its two p50 times
are host dispatch times), the card's per-observation p50/p99 from CUDA
events (each update from its first launch to its last kernel's end) and
the wall time; then, per recording and length, one line with the
statistical check of the seeds' replays against the JAX replays of the
same recording and length in ``tests/fixtures/torch_locbench_jax.json``
(``check``). ``--all`` replays every recording and length the fixture
holds at its seeds (0-2, and more for the three replays ``chip_smoke.py``
checks): all eight recordings in full but nordschleife (4,000 steps), and
two bounded replays. ``--profile`` adds, from
``torch.profiler`` over the first 200 observations of nordschleife (the
45k-point map): device busy time and launches per observation, the
idle share of the wall, and the share of the three ``nearest_point``
queries. Needs a CUDA device unless ``--device cpu``. Exits 1 when a
replay fails its check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.convert import pf_state_from_numpy, pf_state_to_numpy
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.localise.benchmarking import BenchmarkLocalisation, LocalisationRecording
from acmpc_tpu_torch.localise.benchmarking.benchmark import OBSERVE_RANGE, STEP_RANGE
from acmpc_tpu_torch.localise.localiser import Localiser
from acmpc_tpu_torch.localise.particle_filter import NEAREST_POINT_RANGE, PFState, ScriptedDraws, TorchDraws

ROOT = pathlib.Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_locbench_jax.json"
RECORDINGS = (
    "bathurst_synth", "monza_realperc", "monza_synth", "nordschleife_synth",
    "silverstone_synth", "spa_synth", "vallelunga_synth", "yas_marina_synth",
)
PROFILE_RECORDING, PROFILE_OBSERVATIONS = "nordschleife_synth", 200
# card against CPU, one call from one state with the same draws: the
# card's cumsum and reductions run in another order than the CPU's
CARD_CPU_XY_M, CARD_CPU_YAW_RAD = 1e-3, 1e-4
# resampling draws that may move (a uniform within rounding of a
# cumulative-weight boundary), as a share of the particles
MOVED_DRAWS_MAX_SHARE = 0.01
# a replay whose steady-state error exceeds the convergence distance of
# every shipped config has claimed a fix on an alias of the track
ALIAS_M = 50.0
# the JAX package's own platform-drift bounds (tests/test_locbench_replay.py)
PERCENT_LOCALISED_DROP, POSITION_ERROR_M, ROTATION_ERROR_DEG, EXTRA_RESETS = 5.0, 1.0, 1.0, 1


def track_of(recording: str) -> str:
    return recording.rsplit("_", 1)[0]


def make_bench(recording: str, seed: int = 0, device=None) -> BenchmarkLocalisation:
    """The replay of one committed recording with its track's shipped
    config and map; a missing recording, config or map raises."""
    track = track_of(recording)
    data = ROOT / "data" / "localisation" / recording / "racing"
    for path in (data / "control.npy", data / "observations.npy"):
        if not path.is_file():
            raise FileNotFoundError(f"no recording at {path}")
    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    return BenchmarkLocalisation(
        str(data),
        str(ROOT / "data" / "maps" / f"{track}.npz"),
        dataclasses.replace(cfg.localisation, collect_benchmark_observations=False),
        vehicle=cfg.vehicle,
        seed=seed,
        device=device,
    )


def _percentile(values, q):
    return float(np.percentile(values, q)) if values else None


def replay(recording: str, seed: int = 0, max_steps: int | None = None, device=None) -> dict:
    """One replay: the tracker's summary, unrounded, plus the card's
    per-observation times and the wall time."""
    bench = make_bench(recording, seed, device)
    t0 = time.perf_counter()
    summary = bench.run(max_steps=max_steps)
    wall = time.perf_counter() - t0
    device_ms = bench.observation_device_ms()
    return {
        "recording": recording,
        "seed": seed,
        "max_steps": max_steps,
        **summary,
        "observation_sync_p50_ms": _percentile(device_ms, 50),
        "observation_sync_p99_ms": _percentile(device_ms, 99),
        "wall_s": wall,
        "device": str(bench.localiser.device),
    }


def load_fixture(path: pathlib.Path = FIXTURE) -> dict:
    return json.loads(path.read_text())["replays"]


def _on_track(summary: dict) -> bool:
    """Converged, and not on an alias."""
    err = summary["steady_state_position_error_m"]
    return summary["steps_to_first_convergence"] is not None and err is not None and err <= ALIAS_M


def _jax_summaries(rows: list[dict], fixture: dict) -> list[dict]:
    """The fixture's JAX summaries of the recording and length of ``rows``."""
    key = (rows[0]["recording"], rows[0]["max_steps"])
    return [r["summary"] for r in fixture.values() if (r["recording"], r["max_steps"]) == key]


def _outside_bounds(row: dict, want: list[dict]) -> list[str]:
    """How one replay falls outside the JAX package's drift bounds around
    the range of the JAX seeds ``want`` that fixed on the track (all of
    them when none did; empty: it is inside)."""
    if row["steps_to_first_convergence"] is None:
        return ["never converged"]
    sound = [w for w in want if _on_track(w)] or want

    def span(key):
        values = [w[key] for w in sound if w[key] is not None]
        return min(values), max(values)

    fails = []
    localised, (lo, _) = row["steady_state_percent_localised"], span("steady_state_percent_localised")
    if localised < lo - PERCENT_LOCALISED_DROP:
        fails.append(f"steady-state localised {localised} < {lo} - {PERCENT_LOCALISED_DROP}")
    for key, margin in (("steady_state_position_error_m", POSITION_ERROR_M),
                        ("mean_rotation_error_deg", ROTATION_ERROR_DEG)):
        got, (lo, hi) = row[key], span(key)
        if not lo - margin <= got <= hi + margin:
            fails.append(f"{key} {got} outside [{lo}, {hi}] +- {margin}")
    resets, (_, hi) = row["n_resets"], span("n_resets")
    if resets > hi + EXTRA_RESETS:
        fails.append(f"{resets} resets > {hi} + {EXTRA_RESETS}")
    return fails


def check(rows: list[dict], fixture: dict) -> list[str]:
    """The failures (none: a pass) of the port's replays ``rows`` of one
    recording and length, one per filter seed, against the JAX replays of
    the same recording and length in ``fixture``, one per seed.

    Every seed must take the JAX replays' step and observation counts. A
    replay is one draw of a chaotic filter, and the two packages draw
    different numbers: either package sometimes claims a fix on an alias
    hundreds of metres off (the JAX filter on monza_realperc at 3 of 10
    seeds, on spa at seeds 1 and 2), and one seed's steady-state error can
    lie metres from another's (2.1-8.4 m on monza_realperc). So at
    least one seed must lie inside the JAX package's drift bounds around
    the range of the JAX seeds that fixed on the track (error at most
    ``ALIAS_M``): converged, steady-state percent localised at least the
    lowest JAX seed's less 5, steady-state position error and mean
    rotation error within 1.0 of the JAX range, at most one reset more
    than the most a JAX seed had. That the filters agree call by call is
    the CPU tests' and ``devices_agree``'s to show."""
    want = _jax_summaries(rows, fixture)
    if not want:
        return [f"no JAX replay of {rows[0]['recording']} at max_steps {rows[0]['max_steps']} in the fixture"]
    fails = []
    for k in ("n_steps", "n_observations"):
        got, expected = sorted({r[k] for r in rows}), sorted({w[k] for w in want})
        if got != expected or len(got) != 1:
            fails.append(f"{k} {got} != {expected}")
    outside = {row["seed"]: _outside_bounds(row, want) for row in rows}
    if all(outside.values()):
        fails += [f"seed {seed}: {'; '.join(f)}" for seed, f in outside.items()]
    return fails


def seeds_inside(rows: list[dict], fixture: dict) -> list[int]:
    """The seeds of ``rows`` inside the drift bounds of ``check``."""
    want = _jax_summaries(rows, fixture)
    return [row["seed"] for row in rows if not _outside_bounds(row, want)]


def steps_before(recording: str, n_observations: int) -> int:
    """Control steps a replay takes to reach its ``n_observations``-th
    observation."""
    steps = seen = 0
    for record in LocalisationRecording(str(ROOT / "data" / "localisation" / recording / "racing")):
        if "control_command" in record:
            steps += 1
        elif "tracklimits" in record:
            seen += 1
            if seen == n_observations:
                break
    return steps


def _ranges(prof, names) -> dict:
    """Per record_function name: its calls, the device microseconds and
    the launches of every operator under it."""
    out = {name: {"calls": 0, "device_us": 0.0, "launches": 0} for name in names}
    for evt in prof.events():
        if evt.name not in out or evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        row = out[evt.name]
        row["calls"] += 1
        row["device_us"] += evt.device_time_total
        stack = [evt]
        while stack:
            e = stack.pop()
            row["launches"] += len(e.kernels)
            stack.extend(e.cpu_children)
    return out


def profile(recording: str = PROFILE_RECORDING, observations: int = PROFILE_OBSERVATIONS, device=None) -> dict:
    """The first ``observations`` observations of a replay under
    ``torch.profiler`` (after an untimed warm replay of 20 steps): device
    busy time and launches per observation, idle share of the profiled
    wall, the ``nearest_point`` share of the busy time, and the update's
    and the step's own device time and launches per call."""
    device = resolve_device(device)
    make_bench(recording, 0, device).run(max_steps=20)
    n_steps = steps_before(recording, observations)
    bench = make_bench(recording, 0, device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        summary = bench.run(max_steps=n_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    names = (STEP_RANGE, OBSERVE_RANGE, NEAREST_POINT_RANGE)
    busy_us, per_kernel = device_time(prof, exclude=names)
    ranges = _ranges(prof, names)
    n_obs = summary["n_observations"]
    launches = sum(n for _, n in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    per_call = {
        name: {
            "calls": r["calls"],
            "device_ms_per_call": r["device_us"] / 1e3 / max(r["calls"], 1),
            "launches_per_call": r["launches"] / max(r["calls"], 1),
        }
        for name, r in ranges.items()
    }
    measured = busy_us > 0
    return {
        "recording": recording,
        "map_points": bench.localiser.map.n_centre,
        "steps": summary["n_steps"],
        "observations": n_obs,
        "profiled_wall_ms_per_observation": wall_us / 1e3 / n_obs,
        "device_busy_ms_per_observation": busy_us / 1e3 / n_obs if measured else "not measured",
        "launches_per_observation": launches / n_obs if measured else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if measured else "not measured",
        "nearest_point_share_of_busy": (
            ranges[NEAREST_POINT_RANGE]["device_us"] / busy_us if measured else "not measured"
        ),
        "per_call": per_call,
        "top_kernels_ms_per_observation": [
            {"name": name[:90], "ms": us / 1e3 / n_obs, "calls_per_observation": n / n_obs}
            for name, (us, n) in top
        ],
    }


def first_observation(recording: str):
    """The ground-truth pose ({x, y, yaw}) of the last control record
    before the recording's first observation, and that observation."""
    pose = None
    for record in LocalisationRecording(str(ROOT / "data" / "localisation" / recording / "racing")):
        if "game_pose" in record:
            pose = record["game_pose"][0]
        elif "tracklimits" in record and pose is not None:
            return pose, record["tracklimits"]
    raise ValueError(f"{recording} has no observation after a control record")


def _localiser(track: str, device) -> Localiser:
    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    return Localiser(cfg.localisation, str(ROOT / "data" / "maps" / f"{track}.npz"), vehicle=cfg.vehicle,
                     device=device)


def _compare(card: PFState, cpu: PFState) -> dict:
    """Card against CPU: the largest position and yaw differences among
    the particles within the agreement bounds, and how many lie outside
    them (a moved resampling draw puts a particle on another parent)."""
    a, b = pf_state_to_numpy(card), pf_state_to_numpy(cpu)
    dxy = np.linalg.norm(a["states"][:, :2] - b["states"][:, :2], axis=1)
    dyaw = np.abs(a["states"][:, 2] - b["states"][:, 2])
    moved = (dxy > CARD_CPU_XY_M) | (dyaw > CARD_CPU_YAW_RAD)
    return {
        "max_xy_m": float(dxy[~moved].max(initial=0.0)),
        "max_yaw_rad": float(dyaw[~moved].max(initial=0.0)),
        "moved": int(moved.sum()),
        "valid_equal": bool(np.array_equal(a["valid"], b["valid"])),
        "converged_equal": bool(a["converged"] == b["converged"]),
        "max_score_rel": float(np.max(np.abs(a["scores"] - b["scores"]) / np.maximum(b["scores"], 1e-30))),
    }


def devices_agree(track: str = "monza", recording: str = "monza_synth", seed: int = 0, card="cuda") -> dict:
    """The track's shipped filter on ``card`` and on the CPU, each call
    from the same state with the same scripted draws (numpy, ``seed``):
    one predict; one update on the recording's first observation; one
    forced resample of a cloud with a fifth of its slots dead and weights
    whose ESS collapses, so every slot is drawn. The cloud: half round the
    true pose, half the blind prior. Each call's input is the CPU's
    previous output."""
    locs = {"card": _localiser(track, card), "cpu": _localiser(track, "cpu")}
    host = locs["cpu"]
    n = host._pf_config.n_particles
    rng = np.random.default_rng(seed)
    pose, obs = first_observation(recording)
    states = host._pf.reset().states.numpy().copy()
    states[: n // 2] = [pose["x"], pose["y"], pose["yaw"]] + rng.normal(0, [2.0, 2.0, 0.05], (n // 2, 3))
    scores = rng.gamma(2.0, size=n)
    state = {
        **pf_state_to_numpy(host._pf.reset()),
        "states": states.astype(np.float32),
        "scores": (scores / scores.sum()).astype(np.float32),
    }
    (ln, sl), (rn, sr) = host._normalise(obs["left"]), host._normalise(obs["right"])
    draws = [("normal", rng.standard_normal(n)), ("normal", rng.standard_normal(n)),
             ("uniform", rng.random()), ("normal", rng.standard_normal((n, 3))),
             ("uniform", rng.random()), ("normal", rng.standard_normal((n, 3)))]

    def predict(loc, s, d):
        return loc._pf.predict(s, 0.02, 22.0, 0.05, d)

    def update(loc, s, d):
        points, masks = loc._upload([loc._pad(ln), loc._pad(rn)])
        return loc._pf.update(s, points[0], masks[0], points[1], masks[1], d, sl, sr)

    def resample(loc, s, d):
        weights = rng_w / rng_w.sum()
        s = s.replace(scores=torch.as_tensor(weights, device=loc.device),
                      valid=torch.as_tensor(alive, device=loc.device))
        return loc._pf._resample(s, d, torch.as_tensor(int(alive.sum()), device=loc.device),
                                 torch.full((), 1.0, device=loc.device))

    rng_w = rng.gamma(0.05, size=n).astype(np.float32)
    alive = rng.random(n) > 0.2
    rng_w[~alive] = 0.0
    out = {}
    for name, call in (("predict", predict), ("update", update), ("resample", resample)):
        results = {}
        for key, loc in locs.items():
            scripted = ScriptedDraws(draws, loc.device)
            results[key] = call(loc, pf_state_from_numpy(state, loc.device), scripted)
        out[name] = _compare(results["card"], results["cpu"])
        state = pf_state_to_numpy(results["cpu"])
        draws = draws[len(draws) - len(scripted):]
    return out


def reset_states_agree(tracks, card="cuda") -> dict:
    """Per track: the blind reset's states on ``card`` against the CPU's
    (the indices are the same host array, ``reset_indices``)."""
    out = {}
    for track in tracks:
        a, b = (_localiser(track, d)._pf.reset() for d in (card, "cpu"))
        diff = (a.states.cpu() - b.states).abs()
        out[track] = {"max_xy_m": float(diff[:, :2].max()), "max_yaw_rad": float(diff[:, 2].max())}
    return out


def sync_free(track: str = "monza", recording: str = "monza_synth", pairs: int = 50) -> dict:
    """``pairs`` predict + update pairs of the filter on the card, then
    ``pairs`` step + observe pairs of the facade, under
    ``torch.cuda.set_sync_debug_mode("error")``: a read of the card, or a
    copy that waits for it, raises."""
    loc = _localiser(track, "cuda")
    pf, draws = loc._pf, TorchDraws(0, loc.device)
    _, obs = first_observation(recording)
    (ln, sl), (rn, sr) = loc._normalise(obs["left"]), loc._normalise(obs["right"])
    points, masks = loc._upload([loc._pad(ln), loc._pad(rn)])

    def pair(state):
        state = pf.predict(state, 0.02, 22.0, 0.05, draws)
        return pf.update(state, points[0], masks[0], points[1], masks[1], draws, sl, sr)

    state = pair(pf.reset())  # first use of every shape, outside the check
    loc.step((0.0, 0.0, 22.0), dt=0.05)
    loc.observe_tracklimits(obs["left"], obs["right"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(pairs):
            state = pair(state)
        for _ in range(pairs):
            loc.step((0.0, 0.0, 22.0), dt=0.05)
            loc.observe_tracklimits(obs["left"], obs["right"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"filter_pairs": pairs, "facade_pairs": pairs, "finite": bool(torch.isfinite(state.states).all())}


def _nan_to_none(row: dict) -> dict:
    return {k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in row.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--all", action="store_true", help="every replay the fixture holds, at its seeds")
    parser.add_argument("--recordings", nargs="+", default=[], choices=RECORDINGS)
    parser.add_argument("--seeds", nargs="+", type=int, default=[0])
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", default=None, help="also append the JSON lines here")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("locbench: no CUDA device is available", file=sys.stderr)
        return 2

    fixture = load_fixture()
    runs = {(r, args.max_steps): args.seeds for r in args.recordings}
    if args.all:
        runs = {}
        for v in fixture.values():
            runs.setdefault((v["recording"], v["max_steps"]), []).append(v["seed"])
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    lines, failed = [], 0
    for (recording, max_steps), seeds in sorted(runs.items(), key=str):
        seeds = sorted(seeds)
        rows = []
        for seed in seeds:
            rows.append(replay(recording, seed, max_steps, device))
            lines.append(json.dumps({**_nan_to_none(rows[-1]), "card": card}))
            print(lines[-1], flush=True)
        fails = check(rows, fixture)
        failed += bool(fails)
        lines.append(json.dumps({"check": f"{recording}/{max_steps or 'all'}", "seeds": seeds,
                                 "seeds_inside": seeds_inside(rows, fixture), "result": fails or "pass"}))
        print(lines[-1], flush=True)
    if args.profile:
        lines.append(json.dumps({"profile": profile(device=device), "card": card}))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
