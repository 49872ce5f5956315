#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``acmpc_tpu_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:
  1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     TF32 flags (must be off);
  2. build: compiles both kernel sources (csrc/admm_chunk.cu, the cluster
     kernel, and csrc/admm_chunk_stream.cu, the streaming kernel) side by
     side with nvcc into build/torch_kernels/, and prints what ptxas
     reports of each kernel (registers, spills);
  3. kernel: each variant against the plain PyTorch version on random
     operators: the cluster kernel at the horizon-50 shapes (n = 248,
     m = 398), B in {1, 7, 256}, the streaming kernel at the horizon-100
     shapes (n = 498, m = 798), B in {1, 8}, each with and without a mixed
     ``active`` mask; times, the streaming kernel at the horizon-50 shapes
     as the figure before the cluster design, the cluster sizes C in
     {5, 6, 8} at B = 256 and {8, 16} at B = 1, and for every C that fits,
     its shared bytes per CTA and how many such clusters the card holds;
  4. main path: monza racing config, horizon 50, B = 256 windows of a
     difficulty ramp through ``SpatialMPC.batched_get_control_fused``:
     one cold step with converged-scenario skipping on, then five
     warm-started steps; every scenario must solve, both cluster kernel
     variants must have launched, and 8 scenarios must agree with the
     plain path on the CPU;
  5. single entry: ``SpatialMPC.get_control`` (B = 1) on the 7 tracks x 5
     golden windows against tests/fixtures/golden_controls.npz (through
     the cluster kernel), and the warm-started B = 1 step time;
  6. mapping control: monza's mapping config (horizon 100), B = 8 gentle
     windows of the ramp: one cold step with skipping on and one warm
     step, all solved, through both streaming kernel variants; 2
     scenarios agree with the plain path on the CPU.
Then the kernels line, the card line and, last, the result line. Any
failure raises and the exit code is not 0. Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DEVICE = "cuda"
HORIZON = 50
BATCH = 256
# chunk shapes: horizon 50 (racing) and horizon 100 (mapping)
H50 = (248, 398)
H100 = (498, 798)
MAPPING_BATCH = 8
N_ITERS, ALPHA = 25, 1.6
TRACKS = [
    "monza", "spa", "silverstone", "nordschleife",
    "vallelunga", "bathurst", "yas_marina",
]
# H100 SXM data-sheet peaks (dense, 700 W): HBM3 bytes/s, fp32 flop/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# kernel vs plain: both reduce in fp32 but in different orders (warp
# shuffles vs cuBLAS); 25 dependent iterations carry the ~1e-7 relative
# rounding of each product to ~1e-5 of the iterates' scale
KERNEL_RTOL = 1e-4
# golden fixture tolerance, as tests/test_golden.py
GOLDEN_TOL = 5e-3
# port on the card vs port on the CPU, same inputs: the two take the
# same number of chunks, and differ by fp32 rounding in the kernel, the
# batched Cholesky and the reductions
CPU_AGREE_TOL = 2e-3


def emit(phase: str, payload: dict) -> None:
    print(f"{phase}: {json.dumps(payload)}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_bound(n: int, m: int, n_iters: int, n_active: int, batch: int, masked: bool):
    """Least time of one chunk call on an H100: each input read once and
    each output written once, against the flops of the active scenarios'
    iterations. Returns (ms, "bytes" | "operations")."""
    operator = 4 * (n * (n + m) + m * n + n + 3 * m)  # W, A, c0, rho, l, u
    iterates = 4 * (n + 2 * m)  # x, z, y
    n_bytes = n_active * operator + 2 * batch * iterates + (batch if masked else 0)
    per_iter = 2 * n * (n + m) + 2 * m * n + 12 * m + 4 * n
    flops = n_active * n_iters * per_iter
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def random_chunk_inputs(batch: int, n: int, m: int, seed: int, device):
    """Chunk inputs at the true shapes from random well-posed box QPs:
    the ADMM operator of P = M M'/n + I/2, A (m, n) with every 17th row an
    equality, rho 0.1 (1e2 on equalities), so the iterates stay bounded
    as in a real solve."""
    import torch

    from acmpc_tpu_torch.qp.admm import _build_operator, _factor, _rho_vector

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=device)

    M = randn(batch, n, n, scale=n**-0.5)
    P = M @ M.transpose(-1, -2) + 0.5 * torch.eye(n, device=device)
    q = randn(batch, n)
    A = randn(batch, m, n, scale=n**-0.5)
    centre = (A @ randn(batch, n, 1))[..., 0]
    half = 0.5 + torch.rand(batch, m, generator=g, device=device)
    half[:, ::17] = 0.0
    lo, hi = centre - half, centre + half
    rho = _rho_vector(torch.tensor(0.1, device=device), lo, hi)
    W, c0 = _build_operator(_factor(P, A, rho, 1e-5), A, q, 1e-5)
    x = randn(batch, n, scale=0.1)
    z = torch.clamp((A @ x[..., None])[..., 0], lo, hi)
    y = randn(batch, m, scale=0.1)
    return W, A.contiguous(), c0, rho, lo, hi, x, z, y


def phase_device() -> dict:
    import torch

    import acmpc_tpu_torch  # noqa: F401  (sets the TF32 flags)

    info = {
        "card": card_line(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    if info["matmul_allow_tf32"] or info["cudnn_allow_tf32"]:
        raise RuntimeError("TF32 is on")
    emit("phase 1 device", info)
    return info


def phase_build() -> dict:
    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops
    from acmpc_tpu_torch.ops.cuda_build import BUILD_DIR

    t0 = time.perf_counter()
    ops._libraries(torch.cuda.current_device())
    info = {"sources": sorted(ops.SOURCES.values()), "build_s": time.perf_counter() - t0}
    # what ptxas said of each kernel built in this run
    for log in sorted(BUILD_DIR.glob("*.log")):
        if log.stat().st_mtime >= time.time() - info["build_s"] - 5:
            info[log.stem] = [
                line.split("ptxas info    : ", 1)[-1]
                for line in log.read_text().splitlines()
                if "Used" in line or "spill" in line
            ]
    emit("phase 2 build", info)
    return info


def compare(got, want, label: str) -> float:
    """Max abs difference of kernel outputs from the plain version's;
    raises unless finite and within KERNEL_RTOL of the iterates' scale."""
    import torch

    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(bool(torch.isfinite(a).all()) for a in got):
        raise RuntimeError(f"{label}: kernel output not finite")
    if err > KERNEL_RTOL * scale:
        raise RuntimeError(
            f"{label}: kernel disagrees with its plain version: "
            f"max abs err {err} > {KERNEL_RTOL} * {scale}"
        )
    return err


def phase_kernel() -> dict:
    """Both kernel variants against their plain version on the card, with
    times, the cluster-size sweep and the streaming kernel's figure at
    the horizon-50 shapes."""
    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops

    dev = torch.cuda.current_device()
    lib = ops._libraries(dev)["cluster"]
    n, m = H50
    clusters = {}
    for C in range(1, ops.MAX_CLUSTER + 1):
        smem = ops.cluster_smem_bytes(n, m, C)
        if lib.admm_chunk_cluster_smem_bytes(n, m, C) != smem:
            raise RuntimeError(f"C={C}: the wrapper's shared-memory layout is not the kernel's")
        if smem <= ops.SMEM_PER_BLOCK:
            clusters[C] = {
                "smem_bytes": smem,
                "max_active_clusters": ops.cluster_max_active(n, m, C, dev),
            }
    stream_plan = ops.ChunkPlan("stream", 1, ops.stream_smem_bytes(n, m))
    sweep = {1: (8, 16), BATCH: (5, 6, 8)}

    results = {"clusters_h50": clusters}
    for (n, m), batches in ((H50, (1, 7, BATCH)), (H100, (1, MAPPING_BATCH))):
        for batch in batches:
            inputs = random_chunk_inputs(batch, n, m, seed=batch, device=DEVICE)
            active = torch.arange(batch, device=DEVICE) % 3 != 1
            plan = ops.plan_chunk(n, m, batch)
            timed = (n, m) == H50 and batch in (1, BATCH) or (n, m) == H100 and batch == MAPPING_BATCH
            for masked in (False, True):
                mask = active if masked else None
                key = f"n{n}_B{batch}{'_active' if masked else ''}"

                def run(p=plan, mask=mask):
                    return ops._launch(p, *inputs, n_iters=N_ITERS, alpha=ALPHA, active=mask)

                def plain(mask=mask):
                    return ops.admm_chunk_reference(*inputs, n_iters=N_ITERS, alpha=ALPHA, active=mask)

                want = plain()
                ops.admm_chunk.launches.clear()
                got = ops.admm_chunk(*inputs, n_iters=N_ITERS, alpha=ALPHA, active=mask)
                name = ops.CLUSTER if plan.variant == "cluster" else ops.STREAM
                name = f"{name}[active]" if masked else name
                if dict(ops.admm_chunk.launches) != {name: 1}:
                    raise RuntimeError(f"{key}: expected one launch of {name}, got {dict(ops.admm_chunk.launches)}")
                row = {
                    "kernel": name,
                    "C": plan.cluster,
                    "max_abs_err": compare(got, want, key),
                }
                if timed:
                    row["ms"] = time_cuda_ms(run, reps=20)
                    row["plain_ms"] = time_cuda_ms(plain, reps=5)
                    n_active = int(active.sum()) if masked else batch
                    row["bound_ms"], row["bound_by"] = chunk_bound(
                        n, m, N_ITERS, n_active, batch, masked
                    )
                if timed and (n, m) == H50:
                    # the streaming kernel on the same inputs: the figure
                    # before the cluster design
                    row["stream_max_abs_err"] = compare(run(stream_plan), want, f"{key} stream")
                    row["stream_ms"] = time_cuda_ms(lambda: run(stream_plan), reps=20)
                    row["streaming_bound_ms"] = 1e3 * N_ITERS * n_active * 4 * (
                        n * (n + m) + m * n
                    ) / HBM_BYTES_PER_S
                    if not masked:
                        row["ms_by_C"] = {}
                        for C in sweep[batch]:
                            p = ops.ChunkPlan("cluster", C, ops.cluster_smem_bytes(n, m, C))
                            compare(run(p), want, f"{key} C={C}")
                            row["ms_by_C"][C] = time_cuda_ms(lambda: run(p), reps=20)
                results[key] = row
    emit("phase 3 kernel vs plain", {"n_iters": N_ITERS, **results})
    return results


def difficulty_ramp(horizon: int, batch: int) -> np.ndarray:
    """Feasible BEV centreline windows (y forward), gentle to near the
    lateral-acceleration limit: curvature 2*coeff with coeff from 0.0005
    to 0.035 (a_y 4.5 m/s^2 at v_min 8 m/s, under ay_max 5.5)."""
    from acmpc_tpu_torch.geometry.tracks import get_curved_track, with_widths

    hardest = 0.035
    windows = [
        with_widths(
            get_curved_track(
                0.0005 + (hardest - 0.0005) * i / max(batch - 1, 1),
                horizon,
                angle=-np.pi / 2,
            )
        )
        for i in range(batch)
    ]
    return np.stack(windows).astype(np.float32)


def make_mpc(track: str, device, mode: str = "racing"):
    """The track's racing control cut to horizon 50, or its mapping
    control as configured (horizon 100)."""
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    if mode == "racing":
        control = dataclasses.replace(cfg.racing_control, horizon=HORIZON)
    else:
        control = cfg.mapping_control
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle,
        min_velocity=control.constraints.v_min,
        max_velocity=control.constraints.v_max,
    )
    return SpatialMPC(control, model, device=device)


def phase_main_path() -> dict:
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER, CLUSTER_ACTIVE, admm_chunk

    mpc = make_mpc("monza", DEVICE)
    skipping = make_mpc("monza", DEVICE)
    skipping.admm = dataclasses.replace(skipping.admm, tile_skip=True)
    refs = torch.as_tensor(difficulty_ramp(HORIZON, BATCH), device=DEVICE)
    states = mpc.initial_state(BATCH)

    admm_chunk.launches.clear()
    cold, cold_diags = skipping.batched_get_control_fused(states, refs)
    steps = [cold]
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, diags = mpc.batched_get_control_fused(steps[-1], refs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(new)
    launches = dict(admm_chunk.launches)

    for i, s in enumerate(steps):
        if not bool(s.solved.all()):
            raise RuntimeError(
                f"main path step {i}: {int((~s.solved).sum())} of {BATCH} unsolved"
            )
        for f in dataclasses.fields(s):
            if not bool(torch.isfinite(getattr(s, f.name).float()).all()):
                raise RuntimeError(f"main path step {i}: {f.name} not finite")
    if steps[-1].projected_control.shape != (BATCH, 2, HORIZON - 1):
        raise RuntimeError(f"bad command shape {tuple(steps[-1].projected_control.shape)}")
    for name in (CLUSTER, CLUSTER_ACTIVE):
        if launches.get(name, 0) == 0:
            raise RuntimeError(f"main path never launched {name}")

    # the same cold step through the plain path on the CPU, 8 scenarios
    pick = torch.arange(0, BATCH, BATCH // 8)
    cpu_mpc = make_mpc("monza", "cpu")
    cpu_state, _ = cpu_mpc.batched_get_control_fused(
        cpu_mpc.initial_state(len(pick)), refs[pick].cpu()
    )
    cpu_err = float(
        (cpu_state.projected_control - cold.projected_control[pick].cpu()).abs().max()
    )
    if not bool(cpu_state.solved.all()) or cpu_err > CPU_AGREE_TOL:
        raise RuntimeError(f"card and CPU paths disagree: max abs err {cpu_err}")

    warm_ms = 1e3 * float(np.median(step_s))
    info = {
        "config": "monza racing, horizon 50",
        "batch": BATCH,
        "steps": len(steps),
        "solved_per_step": [int(s.solved.sum()) for s in steps],
        "cold_chunks": int(cold_diags.control_iterations.max()) // mpc.admm.check_every,
        "warm_iterations_max": int(diags.control_iterations.max()),
        "launches": launches,
        "warm_ms_per_step": warm_ms,
        "warm_step_ms_all": [1e3 * s for s in step_s],
        "solves_per_s": BATCH / (warm_ms / 1e3),
        "cpu_plain_max_abs_err": cpu_err,
        "card": card_line(),
    }
    emit("phase 4 main path", info)
    return info


def phase_single_golden() -> dict:
    import torch

    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER, admm_chunk

    golden = np.load(ROOT / "tests" / "fixtures" / "golden_controls.npz")
    windows = battery(HORIZON)
    admm_chunk.launches.clear()
    worst = 0.0
    for track in TRACKS:
        mpc = make_mpc(track, DEVICE)
        v_cap = min(30.0, mpc.config.unlocalised_max_speed or 30.0)
        for name, ref in windows.items():
            key = f"{track}/{name}"
            state, _ = mpc.get_control(mpc.initial_state(), ref, v_cap)
            if bool(state.solved) != bool(golden[f"{key}/solved"]):
                raise RuntimeError(f"{key}: solved flag differs from the fixture")
            if not bool(state.solved):
                continue
            for field in ("projected_control", "cum_time"):
                got = getattr(state, field).cpu().numpy()
                want = golden[f"{key}/{field}"]
                np.testing.assert_allclose(
                    got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL, err_msg=key
                )
                worst = max(worst, float(np.abs(got - want).max()))
    golden_launches = admm_chunk.launches[CLUSTER]
    if golden_launches == 0:
        raise RuntimeError(f"get_control never launched {CLUSTER}")

    # warm-started single-scenario step (the flagship entry's counterpart)
    mpc = make_mpc("monza", DEVICE)
    ref = torch.as_tensor(difficulty_ramp(HORIZON, 1)[0], device=DEVICE)
    state, _ = mpc.get_control(mpc.initial_state(), ref)
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = mpc.get_control(state, ref)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if not bool(state.solved):
        raise RuntimeError("warm single-scenario step unsolved")
    warm_ms = 1e3 * float(np.median(step_s))
    info = {
        "windows": len(TRACKS) * len(windows),
        "golden_max_abs_err": worst,
        "tolerance": GOLDEN_TOL,
        "launches": golden_launches,
        "warm_ms_per_step_B1": warm_ms,
        "solves_per_s_B1": 1e3 / warm_ms,
        "card": card_line(),
    }
    emit("phase 5 single entry + golden", info)
    return info


def phase_mapping() -> dict:
    """Monza's mapping control (horizon 100), whose operator no cluster
    holds: a cold step with skipping on, then a warm step."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import STREAM, STREAM_ACTIVE, admm_chunk

    mpc = make_mpc("monza", DEVICE, mode="mapping")
    skipping = make_mpc("monza", DEVICE, mode="mapping")
    skipping.admm = dataclasses.replace(skipping.admm, tile_skip=True)
    horizon = mpc.config.horizon
    # the gentlest windows of the ramp
    refs = torch.as_tensor(difficulty_ramp(horizon, BATCH)[:MAPPING_BATCH], device=DEVICE)

    admm_chunk.launches.clear()
    cold, _ = skipping.batched_get_control_fused(mpc.initial_state(MAPPING_BATCH), refs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm, _ = mpc.batched_get_control_fused(cold, refs)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(admm_chunk.launches)

    for i, s in enumerate((cold, warm)):
        if not bool(s.solved.all()):
            raise RuntimeError(
                f"mapping step {i}: {int((~s.solved).sum())} of {MAPPING_BATCH} unsolved"
            )
        if not bool(torch.isfinite(s.projected_control).all()):
            raise RuntimeError(f"mapping step {i}: commands not finite")
    if warm.projected_control.shape != (MAPPING_BATCH, 2, horizon - 1):
        raise RuntimeError(f"bad command shape {tuple(warm.projected_control.shape)}")
    for name in (STREAM, STREAM_ACTIVE):
        if launches.get(name, 0) == 0:
            raise RuntimeError(f"mapping control never launched {name}")

    pick = torch.tensor([0, MAPPING_BATCH - 1])
    cpu_mpc = make_mpc("monza", "cpu", mode="mapping")
    cpu_state, _ = cpu_mpc.batched_get_control_fused(
        cpu_mpc.initial_state(len(pick)), refs[pick].cpu()
    )
    cpu_err = float(
        (cpu_state.projected_control - cold.projected_control[pick].cpu()).abs().max()
    )
    if not bool(cpu_state.solved.all()) or cpu_err > CPU_AGREE_TOL:
        raise RuntimeError(f"mapping: card and CPU paths disagree: max abs err {cpu_err}")
    info = {
        "config": f"monza mapping, horizon {horizon}",
        "batch": MAPPING_BATCH,
        "solved_per_step": [int(s.solved.sum()) for s in (cold, warm)],
        "launches": launches,
        "warm_step_ms": 1e3 * warm_s,
        "cpu_plain_max_abs_err": cpu_err,
        "card": card_line(),
    }
    emit("phase 6 mapping control", info)
    return info


def kernels_line(kernel: dict, main: dict, mapping: dict) -> dict:
    """One row per kernel variant: launches from the path that runs it
    (cluster: phase 4; stream: phase 6), numbers from phase 3 at that
    path's shapes."""
    import acmpc_tpu_torch.ops.admm_chunk as ops

    def row(name, key, line, path):
        r = kernel[key]
        source = ops.SOURCES["cluster" if name.startswith(ops.CLUSTER) else "stream"]
        return {
            "name": name,
            "route": "cuda",
            "source": f"acmpc_tpu_torch/csrc/{source}",
            "replaces": f"acmpc_tpu/ops/pallas_admm.py:{line}",
            "launches": path["launches"].get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }

    n50, n100 = H50[0], H100[0]
    return {
        "kernels": [
            row(ops.CLUSTER, f"n{n50}_B{BATCH}", 99, main),
            row(ops.CLUSTER_ACTIVE, f"n{n50}_B{BATCH}_active", 103, main),
            row(ops.STREAM, f"n{n100}_B{MAPPING_BATCH}", 99, mapping),
            row(ops.STREAM_ACTIVE, f"n{n100}_B{MAPPING_BATCH}_active", 103, mapping),
        ]
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import acmpc_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.cuda.set_device(0)
    phase_device()
    phase_build()
    kernel = phase_kernel()
    main_info = phase_main_path()
    phase_single_golden()
    mapping = phase_mapping()
    print(json.dumps(kernels_line(kernel, main_info, mapping)))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
