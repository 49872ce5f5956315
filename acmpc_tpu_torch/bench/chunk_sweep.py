"""Where the time of one ADMM chunk goes on the card: launch-and-load
cost against the cost of one iteration, per kernel variant and cluster
size.

    python -m acmpc_tpu_torch.bench.chunk_sweep

On random well-posed operators (those of chip_smoke.py), times each
variant at n_iters in {0, 25, 50} and prints one JSON line with, per
(shape, B, variant): ms at each count, ``us_per_iter`` (the slope from 25
to 50 iterations) and ``fixed_ms`` (the chunk at 0 iterations: launch,
the operator load of the cluster kernel, and the copies in and out).
Horizon 50 (n = 248, m = 398): the cluster kernel at C in {5, 6, 8, 16},
B in {1, 7, 256}; horizon 100 (n = 498, m = 798): the split kernel at
every C from 8 to 16 with the default ring (4 stages of 8 KB), other
rings at C = 16 (``split_C16_S{stages}_{bytes}``), B in {1, 8}. Each
split row also gives its
resident rows, the bytes each CTA streams per iteration and how many of
its clusters the card holds at once. Then the box block (``box_*`` rows,
on the main path's QPs: chip_smoke.py's ``box_qps`` and
``box_chunk_inputs``): horizon 50 at every C
from 3 to 16 that is a power of two or at most 8, B in {1, 7, 16, 256};
horizon 100 at C in {10, 11, 12, 14, 16}, B in {1, 8}; the raceline at
586 points at C in {7, 8, 12, 16} and at 1,953 points (the split kernel,
C = 16), B = 1; each cluster row with how many of its clusters the card
holds at once. Needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
COUNTS = (0, 25, 50)
# split-kernel rings tried at C = 16 beside the default: (stages, bytes)
RINGS = ((2, 8192), (8, 8192), (2, 16384), (4, 16384), (8, 4096))


def main() -> int:
    if not torch.cuda.is_available():
        print("chunk_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import acmpc_tpu_torch.ops.admm_chunk as ops
    from chip_smoke import ALPHA, H50, H100, box_chunk_inputs, box_qps, random_chunk_inputs, time_cuda_ms

    def plans(n, m):
        out = {
            f"cluster_C{C}": ops.ChunkPlan("cluster", C, ops.cluster_smem_bytes(n, m, C))
            for C in (5, 6, 8, 16)
            if ops.cluster_smem_bytes(n, m, C) <= ops.SMEM_PER_BLOCK
        }
        if not out:
            out = {f"split_C{C}": ops.split_plan(n, m, C) for C in range(8, 17)}
            for stages, size in RINGS:
                out[f"split_C16_S{stages}_{size}"] = ops.split_plan(n, m, 16, stages, size)
        return out

    def split_facts(n, m, plan):
        lay = ops.split_layout(n, m, plan.cluster, plan.stages, plan.stage_bytes)
        streamed = (lay.rows_w - lay.res_w) * (n + m) + (lay.rows_a - lay.res_a) * n
        return {
            "resident_rows_w_a": [lay.res_w, lay.res_a],
            "rows_w_a": [lay.rows_w, lay.rows_a],
            "streamed_bytes_per_cta_iter": 4 * streamed,
            "max_active_clusters": ops.max_active_clusters(plan, n, m, 0),
        }

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
                    **(split_facts(n, m, plan) if plan.variant == "split" else {}),
                })
    box_sizes = {
        H50: ((1, 7, 16, 256), (3, 4, 5, 6, 8, 16)),
        H100: ((1, 8), (10, 11, 12, 14, 16)),
        (586, 586): ((1,), (7, 8, 12, 16)),
        (1953, 1953): ((1,), ()),
    }
    for (n, m), (batches, sizes) in box_sizes.items():
        for batch in batches:
            _, inputs, kw = box_chunk_inputs(*box_qps(n, m, batch))
            plans = {f"box_cluster_C{C}": ops.cluster_plan(n, m, C, n) for C in sizes}
            if not plans:
                plans = {"box_split_C16": ops.split_plan(n, m, 16, n_b=n)}
            for name, plan in plans.items():
                ms = {
                    k: time_cuda_ms(
                        lambda: ops._launch(plan, *inputs, n_iters=k, alpha=ALPHA, **kw), reps=20
                    )
                    for k in COUNTS
                }
                rows.append({
                    "n": n, "m": m, "batch": batch, "variant": name,
                    "planned": plan == ops.plan_chunk(n, m, batch, n),
                    "ms": ms,
                    "us_per_iter": 1e3 * (ms[50] - ms[25]) / 25,
                    "fixed_ms": ms[0],
                    "max_active_clusters": ops.max_active_clusters(plan, n, m, 0),
                })
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
