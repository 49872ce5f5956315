"""Perception in the loop: camera frame -> FPN mask -> banded track-limit
extraction -> centreline refit -> horizon-50 MPC replan, closed loop
around a synthetic circuit.

Counterpart of ``bench.py``'s ``_perception_fps`` and
``_perception_in_loop``. The monza perception config with the shipped
checkpoint at its training camera (height 1.2 m, pitch 9 degrees), the
repository's closed-loop MPC (``full_lap.closed_loop_mpc``: horizon 50,
a real-time-iteration budget of 50 ADMM iterations) and the asymmetric
~1.3 km circuit of ``bench.py``, half width 5 m, rendered by the port's
``SyntheticSimulator``. Each frame: ``Perceiver._pipeline`` (the
captured FPN and extraction), the centreline taken every
``n_polyfit_points // horizon`` points (padded with its last point),
widths tapered 10 -> 6 m, ``jitted_get_control`` (the captured step),
then a host P-term on the commanded speed actuates the sim. On the card
the first frame captures both graphs; later frames replay them.

    python -m acmpc_tpu_torch.bench.perception_loop --frames 40 \\
        --width 1280 --height 736 [--profile] [--out f]

Prints one JSON line: ``perception_fps`` (frames chained through the
mask, synchronised at the end, and the FPN / extraction split) and
``perception_in_loop`` (p50/p99 ms per frame, each frame ended by a
synchronise; fps, solve success, lap completion, distance, maximum
off-track). ``--profile`` adds the loop's split into FPN, extraction and
MPC (each ended by a synchronise) and, from ``torch.profiler`` over the
same frames, the device's busy time and idle share and the top kernels.
Sizes other than the config's use ``bench.py``'s reduced-size settings
(bonnet at 5/6 of the height, 200 polyfit points). Needs a CUDA device
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from acmpc_tpu_torch.bench.full_lap import closed_loop_mpc
from acmpc_tpu_torch.bench.step_breakdown import device_time
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.geometry.tracks import offset_boundaries
from acmpc_tpu_torch.localise.track_map import TrackMap
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "monza.yaml"
HALF_WIDTH = 5.0
DT = 0.05
K_SPEED = 0.5  # host actuation: P-term on the commanded speed


def perception_config(
    width: int = 1280, height: int = 736, precision: str | None = None
) -> PerceptionConfig:
    """monza's perception block at the shipped checkpoint's training
    camera; at another size than the config's, ``bench.py``'s
    reduced-size bonnet row and polyfit count."""
    cfg = load_config(CONFIG).perception
    changes = dict(camera_position=(0.0, 0.0, 1.2), camera_pitch_deg=9.0)
    if (width, height) != (cfg.image_width, cfg.image_height):
        changes.update(
            image_width=width,
            image_height=height,
            n_rows_to_remove_bonnet=height * 5 // 6,
            n_polyfit_points=200,
        )
    if precision is not None:
        changes["precision"] = precision
    return dataclasses.replace(cfg, **changes)


def circuit(n_points: int = 1500):
    """``bench.py``'s asymmetric closed circuit: centre (n, 2), its left
    and right boundaries at HALF_WIDTH, and the lap length in metres."""
    theta = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    r = 200.0 + 30.0 * np.sin(theta) + 15.0 * np.sin(2 * theta) + 7.0 * np.cos(5 * theta)
    centre = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    left, right = offset_boundaries(centre, HALF_WIDTH)
    lap_m = float(np.linalg.norm(np.roll(centre, -1, 0) - centre, axis=1).sum())
    return centre, left, right, lap_m


def make_sim(cfg: PerceptionConfig, centre, left, right) -> SyntheticSimulator:
    tm = TrackMap(
        centre=torch.tensor(centre, dtype=torch.float32),
        left=torch.tensor(left, dtype=torch.float32),
        right=torch.tensor(right, dtype=torch.float32),
    )
    return SyntheticSimulator(
        tm, CameraInfo.from_config(cfg), dt=DT, start_index=0, half_width=HALF_WIDTH
    )


def adversarial_masks(height: int, width: int):
    """The four adversarial masks of
    tests/test_track_extraction_adversarial.py (64 x 96, bonnet at row
    56: straight road, hairpin whose rows cross the track twice, straight
    road plus a disconnected blob, straight road with an 8-row break),
    scaled up by nearest neighbour to (height, width), for the chain-scan
    checks at full size; returns ({name: mask}, the scaled bonnet row)."""
    H, W, bonnet = 64, 96, 56

    def fill(m, rows, lo, hi):
        m[rows, max(0, lo):min(W, hi)] = 1

    straight = np.zeros((H, W), np.uint8)
    fill(straight, slice(8, bonnet), 36, 60)
    hairpin = np.zeros((H, W), np.uint8)
    fill(hairpin, slice(20, bonnet), 30, 50)
    fill(hairpin, slice(12, 20), 30, 86)
    fill(hairpin, slice(20, 48), 66, 86)
    blob = straight.copy()
    fill(blob, slice(30, 40), 4, 14)
    long_gap = straight.copy()
    long_gap[28:36, :] = 0
    rows = np.arange(height) * H // height
    cols = np.arange(width) * W // width
    masks = {
        name: m[rows][:, cols]
        for name, m in (("straight", straight), ("hairpin", hairpin), ("noise_blob", blob), ("long_gap", long_gap))
    }
    return masks, bonnet * height // H


def sim_masks(sim, centre: np.ndarray, n: int):
    """Masks the sim renders at ``n`` poses spread around its circuit,
    each off the centreline by up to 2 m and 0.15 rad."""
    masks = []
    for k in range(n):
        sim.x, sim.y, sim.yaw = _pose(centre, k, n)
        masks.append(sim.render_drivable_mask())
    return masks


def _pose(centre: np.ndarray, k: int, n: int) -> tuple[float, float, float]:
    i = k * len(centre) // n
    p0, p1 = centre[i], centre[(i + 1) % len(centre)]
    heading = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0]))
    normal = np.array([-np.sin(heading), np.cos(heading)])
    pos = p0 + 2.0 * np.sin(1.7 * k) * normal
    return float(pos[0]), float(pos[1]), heading + 0.15 * np.cos(2.3 * k)


def sim_frames(sim, centre: np.ndarray, n: int):
    """Frames and their masks, rendered at :func:`sim_masks`'s ``n``
    poses, each with its own texture seed."""
    images, masks = [], []
    for k, mask in enumerate(sim_masks(sim, centre, n)):
        sim.x, sim.y, sim.yaw = _pose(centre, k, n)
        sim.t = 7.3 * k
        masks.append(mask)
        images.append(sim.render_camera_image(mask))
    return images, masks


def reference_from_tracks(centre: torch.Tensor, horizon: int, n_poly: int) -> torch.Tensor:
    """The MPC reference (horizon, 3) of a perceived centreline: every
    ``n_poly // horizon``-th point, padded with the last, widths tapered
    10 -> 6 m (the production control thread's refit)."""
    ds = max(1, n_poly // horizon)
    pts = centre[::ds][:horizon]
    if pts.shape[0] < horizon:
        pts = torch.cat([pts, pts[-1:].expand(horizon - pts.shape[0], 2)])
    widths = torch.linspace(10.0, 6.0, horizon, dtype=pts.dtype, device=pts.device)
    return torch.stack([pts[:, 0], pts[:, 1], widths], dim=1)


def make_step(perc: Perceiver, mpc):
    """The per-frame pipeline: (state, image) -> (new state, diagnostics,
    reference). Nothing is read back inside it."""
    horizon = mpc.horizon
    n_poly = perc.cfg.n_polyfit_points

    def fused(state, image):
        _, _, tracks = perc._pipeline(image)
        ref = reference_from_tracks(tracks["centre"], horizon, n_poly)
        new_state, diags = mpc.jitted_get_control(state, ref)
        return new_state, diags, ref

    return fused


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _actuate(sim: SyntheticSimulator, state, max_steering_angle: float):
    """The host P-term actuation of ``bench.py``: steering from the first
    commanded steering angle, brake or throttle from the speed error."""
    v_cmd = float(state.projected_control[0, 0])
    delta_cmd = float(state.projected_control[1, 0])
    steering = -delta_cmd / max_steering_angle
    dv = K_SPEED * (v_cmd - sim.v)
    return sim.step(np.array([steering, max(0.0, -dv), max(0.0, min(dv, 1.0))]))


def perception_fps(perc: Perceiver, frames: int = 30, seed: int = 0) -> dict:
    """Frames chained through the mask (each frame's input depends on the
    previous mask), synchronised at the end; then the FPN and the
    extraction alone, each timed with CUDA events over ``frames`` calls
    (host clock with a synchronise on the CPU)."""
    cfg, device = perc.cfg, perc.device
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(
        rng.integers(0, 255, (cfg.image_height, cfg.image_width, 3), dtype=np.uint8),
        device=device,
    )

    def step(img):
        drivable, _, tracks = perc._pipeline(img)
        return (img + drivable[..., None]).to(torch.uint8), tracks["centre"]

    img, centre = step(img)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(frames):
        img, centre = step(img)
    _sync(device)
    dt = (time.perf_counter() - t0) / frames

    mask, _ = perc.segmenter._apply(img)
    fpn_ms = _time_ms(lambda: perc.segmenter._apply(img), frames, device)
    extract_ms = _time_ms(lambda: perc.extractor.extract(mask), frames, device)
    return {
        "perception_ms_per_frame": 1e3 * dt,
        "perception_fps": 1.0 / dt,
        "fpn_ms": fpn_ms,
        "extraction_ms": extract_ms,
        "resolution": f"{cfg.image_width}x{cfg.image_height}",
        "precision": cfg.precision,
    }


def _time_ms(fn, reps: int, device: torch.device) -> float:
    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def perception_in_loop(perc: Perceiver, mpc, sim: SyntheticSimulator, centre, lap_m: float, frames: int) -> dict:
    """The closed loop for up to ``frames`` frames (or a lap): one
    untimed warm frame, then each frame timed from the call to the
    synchronise after it; the sim renders the next frame on the host,
    untimed."""
    device = perc.device
    step = make_step(perc, mpc)
    max_steer = mpc.model.vehicle.max_steering_angle
    obs = sim.reset()
    # on the card a warm frame whose pipeline graph is new captures it: its
    # warm-up launches the chain-edges kernel once more
    captured_warm_frame = device.type == "cuda" and not perc._pipeline.graphs.graphs
    state, _, _ = step(mpc.initial_state(), torch.as_tensor(obs["image"], device=device))
    _sync(device)

    times, solved, offtrack = [], 0, 0.0
    d0 = sim.distance
    for _ in range(frames):
        img = torch.as_tensor(obs["image"], device=device)
        _sync(device)
        t0 = time.perf_counter()
        state, _, _ = step(state, img)
        _sync(device)
        times.append(time.perf_counter() - t0)
        solved += int(state.solved)
        obs = _actuate(sim, state, max_steer)
        offtrack = max(offtrack, float(np.linalg.norm(centre - sim.pose[:2], axis=1).min()))
        if sim.distance - d0 >= lap_m:
            break
    dt = np.asarray(times)
    p50 = float(np.percentile(dt, 50))
    return {
        "p50_ms": 1e3 * p50,
        "p99_ms": 1e3 * float(np.percentile(dt, 99)),
        "ms_all": [1e3 * t for t in times],
        "fps": 1.0 / max(p50, 1e-9),
        "frames": len(times),
        "solve_success": solved / len(times),
        "lap_completed": bool(sim.distance - d0 >= lap_m),
        "distance_m": sim.distance - d0,
        "max_offtrack_m": offtrack,
        "captured_warm_frame": captured_warm_frame,
        "resolution": f"{perc.cfg.image_width}x{perc.cfg.image_height}",
        "precision": perc.cfg.precision,
    }


def profile_loop(perc: Perceiver, mpc, sim: SyntheticSimulator, frames: int) -> dict:
    """``frames`` closed-loop frames twice: split into FPN, extraction
    and MPC, each ended by a synchronise (host clock, medians); then
    unsplit under ``torch.profiler``: the device's busy time per frame,
    its idle share of the wall, and the top kernels."""
    device = perc.device
    horizon, n_poly = mpc.horizon, perc.cfg.n_polyfit_points
    max_steer = mpc.model.vehicle.max_steering_angle
    split = {"fpn_ms": [], "extraction_ms": [], "mpc_ms": []}

    def timed(key, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        split[key].append(1e3 * (time.perf_counter() - t0))
        return out

    obs = sim.reset()
    state = mpc.initial_state()
    for _ in range(frames):
        img = torch.as_tensor(obs["image"], device=device)
        mask, _ = timed("fpn_ms", lambda: perc.segmenter._apply(img))
        tracks = timed("extraction_ms", lambda: perc.extractor.extract(mask))
        ref = reference_from_tracks(tracks["centre"], horizon, n_poly)
        state, _ = timed("mpc_ms", lambda: mpc.get_control(state, ref))
        obs = _actuate(sim, state, max_steer)

    step = make_step(perc, mpc)
    images = []
    for _ in range(frames):
        images.append(torch.as_tensor(obs["image"], device=device))
        obs = _actuate(sim, state, max_steer)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for img in images:
            state, _, _ = step(state, img)
            _sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_kernel = device_time(prof)
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    return {
        "frames": frames,
        **{f"{k}_median": float(np.median(v)) for k, v in split.items()},
        **split,
        "profiled_wall_ms_per_frame": wall_us / 1e3 / frames,
        "device_busy_ms_per_frame": busy_us / 1e3 / frames if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "kernels_per_frame": sum(n for _, n in per_kernel.values()) / frames,
        "top_kernels_ms_per_frame": [
            {"name": name[:90], "ms": us / 1e3 / frames, "calls_per_frame": n / frames}
            for name, (us, n) in kernels[:12]
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=40)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=736)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("perception_loop: no CUDA device is available", file=sys.stderr)
        return 2

    cfg = perception_config(args.width, args.height)
    perc = Perceiver(cfg, device=device)
    mpc = closed_loop_mpc(device)
    centre, left, right, lap_m = circuit()
    sim = make_sim(cfg, centre, left, right)
    out = {}
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    out["device"] = str(device)
    out["perception_fps"] = perception_fps(perc, frames=30)
    out["perception_in_loop"] = perception_in_loop(perc, mpc, sim, centre, lap_m, args.frames)
    if args.profile:
        out["profile"] = profile_loop(perc, mpc, sim, frames=min(args.frames, 10))
    line = json.dumps(out)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
