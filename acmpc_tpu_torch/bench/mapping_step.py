"""The mapping control's warm step on the card, on the box block and on
the dense operator it replaced, in one process.

    python -m acmpc_tpu_torch.bench.mapping_step [--steps 5]

Monza's mapping config (horizon 100: n = 498, m = 798) on the gentlest
windows of chip_smoke.py's difficulty ramp: ``get_control`` at B = 1 and
``batched_get_control_fused`` at B = 8, each from a cold step and then
stepped warm (each step from the previous carry). Every chunk takes the
box block as a diagonal, as the solver does ("box": the cluster kernel,
C = 10) or, for this measurement only, the dense operator ("dense": the
split kernel, C = 16), in the order dense, box, box, dense. Prints one
JSON line: per run, the host-clock ms of each warm step (each ended by a
device synchronise), their median, the chunk launches per warm step by
kernel, and every step solved; then, from ``torch.profiler`` over as many
more warm steps run without those synchronisations, the device's busy ms
per step, its idle share of the wall and the chunk kernel's ms per step;
and the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


@contextlib.contextmanager
def _operator(form: str):
    """Hand every chunk the dense operator ("dense"), or leave the box
    block to the solver ("box")."""
    import acmpc_tpu_torch.qp.admm as admm

    box_block = admm._box_block
    if form == "dense":
        admm._box_block = lambda As, box: None
    try:
        yield
    finally:
        admm._box_block = box_block


def _run(mpc, refs, batch: int, steps: int) -> dict:
    from acmpc_tpu_torch.bench.step_breakdown import device_time
    from acmpc_tpu_torch.ops.admm_chunk import admm_chunk

    def step(state):
        if batch == 1:
            return mpc.get_control(state, refs[0])
        return mpc.batched_get_control_fused(state, refs)

    state, _ = step(mpc.initial_state(None if batch == 1 else batch))
    solved = [bool(state.solved.all())]
    step_ms, launches = [], []
    for _ in range(steps):
        admm_chunk.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(dict(admm_chunk.launches))
        solved.append(bool(state.solved.all()))

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, per_kernel = device_time(prof)
    chunk_us = sum(us for name, (us, _) in per_kernel.items() if "admm_chunk" in name)
    return {
        "warm_ms_per_step": float(np.median(step_ms)),
        "warm_step_ms_all": step_ms,
        "chunk_launches_per_warm_step": launches,
        "all_solved": all(solved),
        "profiled_wall_ms_per_step": wall_us / 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps if busy_us else "not measured",
        "device_idle_share": 1.0 - busy_us / wall_us if busy_us else "not measured",
        "chunk_kernel_ms_per_step": chunk_us / 1e3 / steps if busy_us else "not measured",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("mapping_step: no CUDA device is available", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from chip_smoke import MAPPING_BATCH, difficulty_ramp, make_mpc

    mpc = make_mpc("monza", "cuda", mode="mapping")
    refs = torch.as_tensor(
        difficulty_ramp(mpc.config.horizon, 256)[:MAPPING_BATCH], device="cuda"
    )
    runs = []
    for batch in (1, MAPPING_BATCH):
        for form in ("dense", "box", "box", "dense"):
            with _operator(form):
                runs.append({"batch": batch, "operator": form, **_run(mpc, refs, batch, args.steps)})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "config": "monza mapping", "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
