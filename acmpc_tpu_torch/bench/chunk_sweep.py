"""Where the time of one ADMM chunk goes on the card: launch-and-load
cost against the cost of one iteration, per kernel variant and cluster
size.

    python -m acmpc_tpu_torch.bench.chunk_sweep

On random well-posed operators (those of chip_smoke.py), times each
variant at n_iters in {0, 25, 50} and prints one JSON line with, per
(shape, B, variant): ms at each count, ``us_per_iter`` (the slope from 25
to 50 iterations) and ``fixed_ms`` (the chunk at 0 iterations: launch,
the operator load of the cluster kernel, and the copies in and out).
Horizon 50 (n = 248, m = 398): the cluster kernel at C in {5, 6, 8, 16}
and the streaming kernel, B in {1, 7, 256}; horizon 100 (n = 498,
m = 798): the streaming kernel, B in {1, 8}. Needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
COUNTS = (0, 25, 50)


def main() -> int:
    if not torch.cuda.is_available():
        print("chunk_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import acmpc_tpu_torch.ops.admm_chunk as ops
    from chip_smoke import ALPHA, H50, H100, random_chunk_inputs, time_cuda_ms

    def plans(n, m):
        out = {
            f"cluster_C{C}": ops.ChunkPlan("cluster", C, ops.cluster_smem_bytes(n, m, C))
            for C in (5, 6, 8, 16)
            if ops.cluster_smem_bytes(n, m, C) <= ops.SMEM_PER_BLOCK
        }
        out["stream"] = ops.ChunkPlan("stream", 1, ops.stream_smem_bytes(n, m))
        return out

    rows = []
    for (n, m), batches in ((H50, (1, 7, 256)), (H100, (1, 8))):
        for batch in batches:
            inputs = random_chunk_inputs(batch, n, m, seed=batch, device="cuda")
            for name, plan in plans(n, m).items():
                ms = {
                    k: time_cuda_ms(
                        lambda: ops._launch(plan, *inputs, n_iters=k, alpha=ALPHA), reps=20
                    )
                    for k in COUNTS
                }
                rows.append({
                    "n": n, "m": m, "batch": batch, "variant": name,
                    "planned": plan == ops.plan_chunk(n, m, batch),
                    "ms": ms,
                    "us_per_iter": 1e3 * (ms[50] - ms[25]) / 25,
                    "fixed_ms": ms[0],
                })
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
