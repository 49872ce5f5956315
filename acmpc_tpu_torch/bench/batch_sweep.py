"""The MPC step across batch sizes: latency, throughput, memory and the
chunk plan at each B.

Counterpart of ``bench.py``'s ``_batch_latency``, ``_robustness_batch``
and ``_wide_tile_sweep``: monza's racing control at horizon 50, B = 1
through ``SpatialMPC.get_control`` (the agent's path) and B > 1 through
``batched_get_control_fused``, on ``bench.py``'s mixed windows (half the
difficulty ramp of gentle to near-limit curves, half hairpins of radius
30 + 2i m). Each B: one cold step, then ``STEPS`` warm steps each ended
by a synchronise (blocked p50/p99), then ``CHAIN`` dependent warm steps
with one synchronise at the end (chained ms a step). One JSON line per
B, with the peak of ``torch.cuda.max_memory_allocated``, the chunk plan
(variant, C), the chunk launches per warm step and solved / B:

    python -m acmpc_tpu_torch.bench.batch_sweep                 # B in 1, 8, 32, 256, 4096
    python -m acmpc_tpu_torch.bench.batch_sweep --wide          # and 512, 1024, 2048
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.dynamics import SpatialBicycleModel
from acmpc_tpu_torch.geometry.tracks import get_curved_track, get_hairpin_track, with_widths
from acmpc_tpu_torch.mpc.control_qp import control_qp_sizes
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC
from acmpc_tpu_torch.ops.admm_chunk import admm_chunk, plan_chunk

ROOT = pathlib.Path(__file__).resolve().parents[2]
HORIZON = 50
BATCHES = (1, 8, 32, 256, 4096)  # the robustness batch is the last
WIDE = (512, 1024, 2048)  # bench.py's wide-tile sweep
STEPS, CHAIN = 10, 20


def make_mpc(horizon: int = HORIZON, device=None) -> SpatialMPC:
    """monza's racing control cut to ``horizon``."""
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=horizon)
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle,
        min_velocity=control.constraints.v_min,
        max_velocity=control.constraints.v_max,
    )
    return SpatialMPC(control, model, device=device)


def mixed_refs(horizon: int, batch: int) -> np.ndarray:
    """(B, H, 3) windows: at B = 1 one gentle curve; else half the
    difficulty ramp (curvature 2 * coeff, coeff 0.0005 to 0.035), half
    hairpins of radius 30 + 2i m."""

    def curve(coeff):
        return with_widths(get_curved_track(coeff, horizon, angle=-np.pi / 2))

    if batch == 1:
        return curve(0.002)[None].astype(np.float32)
    n_gentle = batch // 2
    gentle = [curve(0.0005 + 0.0345 * i / max(n_gentle - 1, 1)) for i in range(n_gentle)]
    hard = [with_widths(get_hairpin_track(30.0 + 2.0 * i, horizon)) for i in range(batch - n_gentle)]
    return np.stack(gentle + hard).astype(np.float32)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(mpc: SpatialMPC, batch: int, steps: int = STEPS, chain: int = CHAIN) -> dict:
    """One B: blocked and chained step times, solves/s, peak memory, the
    chunk plan and launches, solved / B."""
    device = mpc.device
    refs = torch.as_tensor(mixed_refs(mpc.horizon, batch), device=device)
    if batch == 1:
        state0 = mpc.initial_state()

        def step(s):
            return mpc.get_control(s, refs[0])[0]

    else:
        state0 = mpc.initial_state(batch)

        def step(s):
            return mpc.batched_get_control_fused(s, refs)[0]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    warm = step(state0)
    _sync(device)
    cold_ms = 1e3 * (time.perf_counter() - t0)

    admm_chunk.launches.clear()
    blocked = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(warm)
        _sync(device)
        blocked.append(1e3 * (time.perf_counter() - t0))
    launches = sum(admm_chunk.launches.values())

    t0 = time.perf_counter()
    cur = warm
    for _ in range(chain):
        cur = step(cur)
    _sync(device)
    chained_ms = 1e3 * (time.perf_counter() - t0) / chain

    n, m = control_qp_sizes(mpc.horizon)
    plan = plan_chunk(n, m, batch, n)  # the control QP's box block
    p50 = float(np.percentile(blocked, 50))
    return {
        "batch": batch,
        "horizon": mpc.horizon,
        "device": str(device),
        "cold_ms": cold_ms,
        "blocked_p50_ms": p50,
        "blocked_p99_ms": float(np.percentile(blocked, 99)),
        "chained_ms_per_step": chained_ms,
        "solves_per_s": batch / (p50 / 1e3),
        "chained_solves_per_s": batch / (chained_ms / 1e3),
        "max_memory_allocated_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "plan": {"variant": plan.variant, "C": plan.cluster, "smem_bytes": plan.smem_bytes, "box": plan.box},
        "chunk_launches_per_step": launches / steps,
        "solved_per_B": float(out.solved.float().mean()),
        "chained_solved_per_B": float(cur.solved.float().mean()),
    }


def card_line() -> str | None:
    """The card's name and power limit (nvidia-smi), where there is one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def sweep(batches, horizon: int = HORIZON, device=None, steps: int = STEPS, chain: int = CHAIN):
    """Yield one row per B; the largest of BATCHES is the robustness batch
    and the WIDE batches the wide-tile sweep."""
    mpc = make_mpc(horizon, resolve_device(device))
    card = card_line() if mpc.device.type == "cuda" else None
    for b in batches:
        stage = "robustness" if b == BATCHES[-1] else "wide_tile" if b in WIDE else "batch_latency"
        row = measure(mpc, b, steps, chain)
        yield {"stage": stage, **row, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--wide", action="store_true", help="add bench.py's wide-tile batches")
    ap.add_argument("--horizon", type=int, default=HORIZON)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--chain", type=int, default=CHAIN)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batches = sorted(set(args.batches) | (set(WIDE) if args.wide else set()))
    for row in sweep(batches, args.horizon, args.device, args.steps, args.chain):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
