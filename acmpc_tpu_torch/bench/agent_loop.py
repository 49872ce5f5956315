"""The racing agent on the synthetic simulator: the runtime shell's three
threads (frame, perception worker, control) around perception,
localisation and both MPCs, measured.

Two runs, each with the JAX e2e tests' lockstep pacing (the frame thread
waits for a command set newer than the last one every 4th frame; every
frame on the mapping lap, see ``MAPPING_PACE_EVERY``):

* ``racing``: monza's config with the shipped FPN at its training camera
  (1280x736 bf16, bonnet 600, 500 polyfit points, as
  ``perception_loop.perception_config()``), real perception, the
  500-particle filter on ``data/maps/monza.npz`` (11,714 centre points)
  and the racing MPC at horizon 50; ``SyntheticSimulator`` on the same
  map, dt 0.05, half width 5 m, from centre index ``RACING_START``. The
  gates of tests/test_agent_e2e.py: a first command within 180 s,
  distance > 50 m, off-track < 5 m, final speed > 10 m/s, no thread
  exception, and a teardown that joins.
* ``mapping``: ``create_map`` with one mapping lap of the small ~330 m
  loop of tests/test_mapping_e2e.py, oracle perception, the mapping MPC
  at monza's horizon 100, then the racing MPC at 50 on the map it built.
  The camera is cut to 320x192 (bonnet 160, 200 polyfit points): the
  host renders every frame with a kd-tree and a lap is ~400 frames. The
  gates of tests/test_mapping_e2e.py: the map and its raw points saved,
  median centre error < 2.5 m, built length > 0.6 of the true length,
  the racing bootstrap with the controller out of mapping mode, then
  100 racing frames with off-track < 5 m and distance > 20 m.

    python -m acmpc_tpu_torch.bench.agent_loop [--run racing|mapping|both]
        [--frames 200] [--profile] [--dashboard] [--device cuda] [--out f]

With ``--dashboard`` the racing run serves the dashboard (``dashboard/``)
on a free port while it drives, and one client thread a stream watches
the composite and every feed over HTTP; the run then also reports the
frames each stream received (each must be a whole JPEG, SOI to EOI),
whether ``/session.json`` parsed, the renderer's passes and exceptions,
and the composite's encode ms.

Prints one JSON line per run: frames, seconds, distance, laps, maximum
off-track, command sets published, ``behaviour()`` wall p50/p99 (the
sim's step excluded), the sim's step p50 (its host render), the frame
thread's pacing wait, the control thread's solves per second, frames
per fresh command set, perception frames run and dropped, the racing
bootstrap's ms, the first localised frame, the kernels' launches and,
with ``--profile``, the device's busy ms, idle share and kernels per
frame over 20 more frames under ``torch.profiler``. Exit 1 when a gate
fails. Needs a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from acmpc_tpu_torch.bench.perception_loop import _sync, perception_config
from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.dashboard import Dashboard
from acmpc_tpu_torch.dashboard.server import FEED_NAMES
from acmpc_tpu_torch.geometry.tracks import offset_boundaries
from acmpc_tpu_torch.localise.track_map import TrackMap, load_track_map
from acmpc_tpu_torch.ops import admm_chunk as chunk_ops
from acmpc_tpu_torch.ops import graph_loop
from acmpc_tpu_torch.ops import jpeg_round_trip as jpeg_ops
from acmpc_tpu_torch.ops import ruiz as ruiz_ops
from acmpc_tpu_torch.ops import track_chain as chain_ops
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime.agent import Agent
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "monza.yaml"
MONZA_MAP = ROOT / "data" / "maps" / "monza.npz"
RACING_START = 0  # monza's centre index 0, on its start straight
DT = 0.05
HALF_WIDTH = 5.0
PACE_EVERY = 4
# the mapping lap waits for a fresh command set every frame: at horizon
# 100 a plan four frames old let the car drift 4.4 m off the small loop
# (a CPU run of this module); tests/test_mapping_e2e.py's lap is not paced
MAPPING_PACE_EVERY = 1
FIRST_COMMAND_S = 180.0
PROFILE_FRAMES = 20
MAPPING_MAX_FRAMES = 4000
BOOTSTRAP_FRAMES = 30
RACING_AFTER_MAPPING = 100
MAPPING_V_MAX, RACING_V_MAX = 14.0, 25.0  # m/s, the small loop's caps


def small_loop_map(m: int = 600) -> TrackMap:
    """tests/test_mapping_e2e.py's small closed loop (~330 m), on the CPU."""
    theta = np.linspace(0, 2 * np.pi, m, endpoint=False)
    r = 52.0 + 5.0 * np.sin(theta) + 2.5 * np.sin(2 * theta)
    centre = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    left, right = offset_boundaries(centre, HALF_WIDTH)
    return TrackMap(*(torch.tensor(a, dtype=torch.float32) for a in (centre, left, right)))


def racing_config():
    """monza with the training camera at full size."""
    cfg = load_config(CONFIG)
    return dataclasses.replace(cfg, perception=perception_config(), map_path=str(MONZA_MAP))


def mapping_config(map_path: str):
    """monza's mapping session (horizon 100, then racing at 50) with one
    mapping lap, monza's camera cut to 320x192 (bonnet 160, 200 polyfit
    points) as tests/test_mapping_e2e.py cuts it, localisation off, and
    tests/test_mapping_e2e.py's speed caps for the small loop (mapping
    14 m/s, racing 25 m/s): the mapping QP's time cost drives it at its
    cap."""
    cfg = load_config(CONFIG)
    r = dataclasses.replace
    return r(
        cfg,
        perception=r(
            cfg.perception, image_width=320, image_height=192,
            n_rows_to_remove_bonnet=160, n_polyfit_points=200,
        ),
        mapping_control=r(
            cfg.mapping_control,
            constraints=r(cfg.mapping_control.constraints, v_max=MAPPING_V_MAX),
        ),
        racing_control=r(
            cfg.racing_control,
            constraints=r(cfg.racing_control.constraints, v_max=RACING_V_MAX),
        ),
        localisation=r(cfg.localisation, use_localisation=False),
        map_path=map_path,
        create_map=True,
        n_mapping_laps=1,
    )


def _launches() -> dict:
    graph_loop.settle_launches()  # the replays' loop-body launches
    counters = (
        chunk_ops.admm_chunk.launches, chain_ops.chain_edges.launches, graph_loop.device_while.launches,
        jpeg_ops.jpeg_round_trip.launches, ruiz_ops.ruiz_equilibrate.launches,
    )
    return dict(sum((collections.Counter(c) for c in counters), collections.Counter()))


def _clear_launches() -> None:
    graph_loop.settle_launches()
    chunk_ops.admm_chunk.launches.clear()
    chain_ops.chain_edges.launches.clear()
    graph_loop.device_while.launches.clear()
    jpeg_ops.jpeg_round_trip.launches.clear()
    ruiz_ops.ruiz_equilibrate.launches.clear()


def _jpeg_fails(launches: dict, camera: bool) -> list:
    """A camera frame is perceived on the card path: one launch of each
    JPEG round-trip kernel a chain-edges launch (an oracle mask: none)."""
    want = launches.get(chain_ops.TRACK_CHAIN_EDGES, 0) if camera else 0
    got = [launches.get(name, 0) for name in (jpeg_ops.BLOCKS_KERNEL, jpeg_ops.COLOUR_KERNEL)]
    return [] if got == [want, want] else [f"JPEG round-trip launches {got}, expected {want} of each"]


def _other_chunk_kernels(launches: dict) -> dict:
    """The chunk kernels in ``launches`` other than the box block's
    cluster kernel, which every control QP of the agent takes."""
    return {
        k: v for k, v in launches.items()
        if k in chunk_ops.KERNEL_NAMES and k != chunk_ops.CLUSTER_BOX and v
    }


class _Drive:
    """Frame loop bookkeeping: ``behaviour()`` walls, off-track, pacing
    on solve freshness, and the first localised frame."""

    def __init__(self, agent: Agent, sim: SyntheticSimulator, centre: np.ndarray, pace_every: int = PACE_EVERY):
        self.agent, self.sim, self.centre = agent, sim, centre
        self.pace_every = pace_every  # 0: no pacing
        self.behaviour_ms: list = []
        self.sim_step_ms: list = []
        self.wait_ms = 0.0  # pacing: the frame thread waiting for a command
        self.max_offtrack = 0.0
        self.frames = 0
        self.first_localised = None
        self.version = agent.controller.command_version

    def frame(self, obs: dict) -> dict:
        agent = self.agent
        # a frame that brakes to finalise the map runs no perception, so
        # no fresh command is coming: never wait on it
        finalising = agent._is_mapping and agent._is_mapping_laps_completed(obs)
        t0 = time.perf_counter()
        action = agent.behaviour(obs)
        t1 = time.perf_counter()
        obs = self.sim.step(action)
        t2 = time.perf_counter()
        self.behaviour_ms.append(1e3 * (t1 - t0))
        self.sim_step_ms.append(1e3 * (t2 - t1))
        self.frames += 1
        if self.pace_every and not finalising and self.frames % self.pace_every == 0:
            self.version = agent.controller.wait_for_command_newer_than(self.version)
            self.wait_ms += 1e3 * (time.perf_counter() - t2)
        d = float(np.linalg.norm(self.centre - self.sim.pose[:2], axis=1).min())
        self.max_offtrack = max(self.max_offtrack, d)
        if self.first_localised is None and agent.is_localised:
            self.first_localised = self.frames
        return obs

    def summary(self) -> dict:
        ms = np.asarray(self.behaviour_ms) if self.behaviour_ms else np.zeros(1)
        step = np.asarray(self.sim_step_ms) if self.sim_step_ms else np.zeros(1)
        return {
            "frames": self.frames,
            "behaviour_p50_ms": float(np.percentile(ms, 50)),
            "behaviour_p99_ms": float(np.percentile(ms, 99)),
            "sim_step_p50_ms": float(np.percentile(step, 50)),
            "pace_wait_ms_per_frame": self.wait_ms / max(self.frames, 1),
            "max_offtrack_m": self.max_offtrack,
            "first_localised_frame": self.first_localised,
        }


def _threads(agent: Agent) -> tuple:
    """The counters of the agent's other threads: command sets, solves,
    solve seconds, perception frames run and dropped."""
    c = agent.controller
    return c.command_version, c.n_solves, c.solve_s, agent.perception_runs, agent.perception_dropped


def _thread_rates(agent: Agent, before: tuple, frames: int, seconds: float) -> dict:
    """What the control thread and the perception worker did since
    ``before`` (``_threads``), over ``frames`` frames in ``seconds``."""
    commands, solves, solve_s, runs, dropped = (a - b for a, b in zip(_threads(agent), before))
    return {
        "command_sets": commands,
        "solves": solves,
        "solves_per_s": solves / seconds,
        "solve_ms_mean": 1e3 * solve_s / max(solves, 1),
        "frames_per_command": frames / max(commands, 1),
        "perception_runs": runs,
        "perception_dropped": dropped,
    }


def _start(agent: Agent, sim: SyntheticSimulator) -> tuple[dict, float]:
    """The first frame (perception, racing bootstrap, the first solve's
    builds) and the wait for the first command set."""
    obs = sim.reset()
    t0 = time.perf_counter()
    agent.behaviour(obs)
    if not agent.controller.wait_for_first_command(timeout=FIRST_COMMAND_S):
        raise RuntimeError(f"the control thread published no command in {FIRST_COMMAND_S} s")
    return obs, time.perf_counter() - t0


def _profile(drive: _Drive, obs: dict, frames: int) -> tuple[dict, dict]:
    device = drive.agent.device
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            obs = drive.frame(obs)
        _sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_kernel = device_time(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return obs, {
        "frames": frames,
        "profiled_wall_ms_per_frame": wall_us / 1e3 / frames,
        "device_busy_ms_per_frame": busy_us / 1e3 / frames if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "kernels_per_frame": sum(n for _, n in per_kernel.values()) / frames,
        "top_kernels_ms_per_frame": [
            {"name": name[:90], "ms": us / 1e3 / frames, "calls_per_frame": n / frames}
            for name, (us, n) in top
        ],
    }


def _teardown(agent: Agent) -> bool:
    """Tear the agent down; True when its control thread and perception
    workers have all ended."""
    thread = agent.controller._thread
    agent.teardown()
    workers = list(getattr(agent.executor, "_threads", ()))
    return not (thread is not None and thread.is_alive()) and not any(w.is_alive() for w in workers)


class _FeedWatcher:
    """A client of one MJPEG stream: reads each part by its
    Content-Length and keeps the count of frames, how many were whole
    JPEGs (SOI first, EOI last), and the last frame."""

    def __init__(self, url: str):
        self.url = url
        self.frames = self.whole = 0
        self.last: bytes | None = None
        self.error: str | None = None
        self.thread = threading.Thread(target=self._run, daemon=True, name=f"watch {url}")
        self.thread.start()

    def _run(self):
        try:
            with urllib.request.urlopen(self.url, timeout=60) as r:
                while True:
                    line = r.readline()
                    if not line:
                        return  # the server ended the stream
                    if not line.lower().startswith(b"content-length:"):
                        continue
                    n = int(line.split(b":", 1)[1])
                    r.readline()  # the blank line after the part's headers
                    frame = r.read(n)
                    self.frames += 1
                    self.whole += frame[:2] == b"\xff\xd8" and frame[-2:] == b"\xff\xd9"
                    self.last = frame
        except Exception as err:  # reported, and the run fails on it
            self.error = repr(err)


def _watch_dashboard(dashboard) -> dict:
    """One watcher for the composite and one for each feed."""
    base = f"http://127.0.0.1:{dashboard.port}"
    urls = {"composite": f"{base}/feed.mjpg", **{f: f"{base}/feed/{f}.mjpg" for f in FEED_NAMES}}
    return {name: _FeedWatcher(url) for name, url in urls.items()}


def _dashboard_report(dashboard, watchers: dict) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{dashboard.port}/session.json", timeout=20) as r:
        session = json.loads(r.read())
    dashboard.stop()  # ends every stream
    for w in watchers.values():
        w.thread.join(timeout=30)
    encode = np.asarray(dashboard.encode_ms) if dashboard.encode_ms else np.full(1, np.nan)
    return {
        "feeds": {
            name: {"frames": w.frames, "whole_jpegs": w.whole, "last_bytes": len(w.last or b""),
                   "error": w.error, "ended": not w.thread.is_alive()}
            for name, w in watchers.items()
        },
        "session_keys": sorted(session),
        "renders": dashboard.renders,
        "render_errors": dashboard.render_errors,
        "last_render_error": dashboard.last_render_error,
        "composite_encode_ms_p50": float(np.percentile(encode, 50)),
        "composite_encode_ms_p99": float(np.percentile(encode, 99)),
        "composites_encoded": len(dashboard.encode_ms),
    }


def _dashboard_fails(report: dict) -> list:
    fails = []
    for name, feed in report["feeds"].items():
        if feed["frames"] < 1 or feed["whole_jpegs"] != feed["frames"] or feed["error"] or not feed["ended"]:
            fails.append(f"dashboard feed {name}: {feed}")
    if report["render_errors"]:
        fails.append(f"dashboard render errors {report['render_errors']}: {report['last_render_error']}")
    if "current" not in report["session_keys"]:
        fails.append(f"session.json keys {report['session_keys']}")
    return fails


def racing_run(frames: int = 200, device="cuda", profile: bool = False, dashboard: bool = False) -> dict:
    """Run ``racing``, with the dashboard served and watched when asked;
    returns its measurements and gate failures."""
    device = torch.device(device)
    cfg = racing_config()
    track_map = load_track_map(cfg.map_path, device="cpu")
    centre = track_map.centre.numpy()
    sim = SyntheticSimulator(
        track_map, CameraInfo.from_config(cfg.perception), dt=DT, start_index=RACING_START, half_width=HALF_WIDTH
    )
    agent = Agent(cfg, sim, use_oracle_perception=False, device=device)
    out: dict = {"run": "racing", "resolution": f"{cfg.perception.image_width}x{cfg.perception.image_height}",
                 "precision": cfg.perception.precision, "particles": cfg.localisation.n_particles,
                 "horizon": cfg.racing_control.horizon, "map_points": int(len(centre)), "start_index": RACING_START}
    joined = False
    dash = watchers = None
    try:
        obs, out["first_command_s"] = _start(agent, sim)
        if dashboard:
            dash = Dashboard(agent, sim, port=0)
            dash.start()
            watchers = _watch_dashboard(dash)
        drive = _Drive(agent, sim, centre)
        d0, before = sim.distance, _threads(agent)
        _sync(device)
        with agent._update_lock:  # no frame is half counted
            _clear_launches()
        t0 = time.perf_counter()
        for _ in range(frames):
            obs = drive.frame(obs)
        _sync(device)
        seconds = time.perf_counter() - t0
        with agent._update_lock:
            out["launches"] = _launches()
        out.update(drive.summary())
        out.update(_thread_rates(agent, before, frames, seconds))
        commands = out["command_sets"]
        out.update(
            seconds=seconds,
            distance_m=sim.distance - d0,
            laps=sim.laps,
            final_speed_ms=sim.v,
            racing_setup_ms=agent.racing_setup_ms,
            thread_exception=repr(agent.thread_exception) if agent.thread_exception else None,
        )
        if profile:
            obs, out["profile"] = _profile(drive, obs, PROFILE_FRAMES)
        if dash is not None:
            out["dashboard"] = _dashboard_report(dash, watchers)
    finally:
        if dash is not None:
            dash.stop()
        joined = _teardown(agent)
    out["teardown_joined"] = joined
    fails = _dashboard_fails(out["dashboard"]) if dashboard else []
    if out["distance_m"] <= 50.0:
        fails.append(f"car barely moved: {out['distance_m']:.1f} m")
    if out["max_offtrack_m"] >= HALF_WIDTH:
        fails.append(f"car left the track: {out['max_offtrack_m']:.2f} m")
    if out["final_speed_ms"] <= 10.0:
        fails.append(f"never accelerated: v={out['final_speed_ms']:.1f}")
    if out["thread_exception"] or not joined:
        fails.append(f"thread exception {out['thread_exception']}, teardown joined {joined}")
    launches = out["launches"]
    if device.type == "cuda":
        cluster = launches.get(chunk_ops.CLUSTER_BOX, 0)
        if not cluster >= commands >= 1:
            fails.append(f"cluster launches {cluster} < command sets {commands} or none published")
        if launches.get(chain_ops.TRACK_CHAIN_EDGES, 0) < 1:
            fails.append("the chain-edges kernel never ran")
        fails += _jpeg_fails(launches, camera=True)
        others = _other_chunk_kernels(launches)
        if others:
            fails.append(f"chunk kernels other than the box-block cluster ran in a racing run: {others}")
    out["fails"] = fails
    return out


def mapping_run(device="cuda", profile: bool = False) -> dict:
    """Run ``mapping``; returns its measurements and gate failures."""
    device = torch.device(device)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    self_map = str(pathlib.Path(tmp.name) / "selfmap.npy")
    cfg = mapping_config(self_map)
    tm = small_loop_map()
    centre = tm.centre.numpy()
    sim = SyntheticSimulator(tm, CameraInfo.from_config(cfg.perception), dt=DT, start_index=10, half_width=HALF_WIDTH)
    agent = Agent(cfg, sim, use_oracle_perception=True, device=device)
    out: dict = {"run": "mapping", "resolution": f"{cfg.perception.image_width}x{cfg.perception.image_height}",
                 "mapping_horizon": cfg.mapping_control.horizon, "racing_horizon": cfg.racing_control.horizon}
    fails = []
    joined = False
    try:
        if not (agent._is_mapping and agent.controller.is_mapping):
            fails.append("the agent did not start in mapping mode")
        obs, out["first_command_s"] = _start(agent, sim)
        drive = _Drive(agent, sim, centre, MAPPING_PACE_EVERY)
        before = _threads(agent)
        _sync(device)
        _clear_launches()
        t0 = time.perf_counter()
        while not agent.mapper.map_built and drive.frames < MAPPING_MAX_FRAMES:
            obs = drive.frame(obs)
        _sync(device)
        seconds = time.perf_counter() - t0
        out["mapping"] = {**drive.summary(), **_thread_rates(agent, before, drive.frames, seconds),
                          "seconds": seconds, "laps": sim.laps, "distance_m": sim.distance,
                          "launches": _launches()}
        if not agent.mapper.map_built:
            raise RuntimeError(f"map never built: laps={sim.laps} d={sim.distance:.0f}")
        stem = self_map.rsplit(".", 1)[0]
        saved = pathlib.Path(self_map).exists() and pathlib.Path(f"{stem}-raw-points.npy").exists()
        built = load_track_map(self_map, device="cpu").centre.numpy()
        err = np.linalg.norm(built[:, None, :] - centre[None, :, :], axis=-1).min(axis=1)
        built_m = float(np.linalg.norm(np.diff(built, axis=0), axis=1).sum())
        true_m = float(np.linalg.norm(np.diff(centre, axis=0), axis=1).sum())
        out["map"] = {"saved": saved, "points": int(len(built)), "median_error_m": float(np.median(err)),
                      "built_m": built_m, "true_m": true_m}
        _clear_launches()
        t0 = time.perf_counter()
        drive.pace_every = 0
        for _ in range(BOOTSTRAP_FRAMES):
            obs = drive.frame(obs)
        racing = _Drive(agent, sim, centre)
        d0, before, t1 = sim.distance, _threads(agent), time.perf_counter()
        for _ in range(RACING_AFTER_MAPPING):
            obs = racing.frame(obs)
        _sync(device)
        out["racing"] = {**racing.summary(),
                         **_thread_rates(agent, before, racing.frames, time.perf_counter() - t1),
                         "seconds": time.perf_counter() - t0,
                         "distance_m": sim.distance - d0, "launches": _launches(),
                         "racing_setup_ms": agent.racing_setup_ms,
                         "out_of_mapping_mode": agent._is_racing_setup and not agent.controller.is_mapping}
        if profile:
            obs, out["profile"] = _profile(racing, obs, PROFILE_FRAMES)
        out["thread_exception"] = repr(agent.thread_exception) if agent.thread_exception else None
    finally:
        joined = _teardown(agent)
        tmp.cleanup()
    out["teardown_joined"] = joined
    m, r = out["map"], out["racing"]
    if not m["saved"]:
        fails.append("the map or its raw points were not saved")
    if m["median_error_m"] >= 2.5:
        fails.append(f"median centre error {m['median_error_m']:.2f} m")
    if m["built_m"] <= 0.6 * m["true_m"]:
        fails.append(f"built {m['built_m']:.0f} m of {m['true_m']:.0f} m")
    if not r["out_of_mapping_mode"]:
        fails.append("no racing bootstrap")
    if r["max_offtrack_m"] >= HALF_WIDTH or r["distance_m"] <= 20.0:
        fails.append(f"racing on the built map: off-track {r['max_offtrack_m']:.2f} m, {r['distance_m']:.1f} m")
    if out["thread_exception"] or not joined:
        fails.append(f"thread exception {out['thread_exception']}, teardown joined {joined}")
    if device.type == "cuda":
        # horizon 100 and then 50, both in a cluster on the box block
        for phase, launches in (("while mapping", out["mapping"]["launches"]), ("after the switch", r["launches"])):
            if launches.get(chunk_ops.CLUSTER_BOX, 0) < 1:
                fails.append(f"the box-block cluster kernel never ran {phase}")
            if _other_chunk_kernels(launches):
                fails.append(f"other chunk kernels ran {phase}: {_other_chunk_kernels(launches)}")
            fails += _jpeg_fails(launches, camera=False)
        if out["mapping"]["launches"].get(chain_ops.TRACK_CHAIN_EDGES, 0) < 1:
            fails.append("the chain-edges kernel never ran")
    out["fails"] = fails
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run", choices=("racing", "mapping", "both"), default="racing")
    parser.add_argument("--frames", type=int, default=200, help="racing frames")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--dashboard", action="store_true", help="serve and watch the dashboard (racing)")
    parser.add_argument("--out", default=None, help="also write the JSON lines here")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("agent_loop: no CUDA device is available", file=sys.stderr)
        return 2
    card = None
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    lines, failed = [], False
    runs = ("racing", "mapping") if args.run == "both" else (args.run,)
    for run in runs:
        if run == "racing":
            result = racing_run(args.frames, device, args.profile, args.dashboard)
        else:
            result = mapping_run(device, args.profile)
        result["card"] = card
        failed |= bool(result["fails"])
        lines.append(json.dumps(result))
        print(lines[-1], flush=True)
    if args.out:
        pathlib.Path(args.out).write_text("\n".join(lines) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
