#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``acmpc_tpu_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:
  1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     TF32 flags (must be off);
  2. build: compiles the five kernel sources (csrc/admm_chunk.cu, the
     cluster kernel; csrc/admm_chunk_split.cu, the split kernel;
     csrc/admm_chunk_stream.cu, the streaming kernel;
     csrc/track_chain.cu, the chain scan; and csrc/track_chain_edges.cu,
     the fused chain-edges kernel) side by side with nvcc into
     build/torch_kernels/, and prints what ptxas reports of each kernel
     (registers, spills);
  3. kernel: each variant against the plain PyTorch version on random
     operators, with and without a mixed ``active`` mask: the cluster
     kernel at the horizon-50 shapes (n = 248, m = 398), B in {1, 7, 256};
     the split kernel at the horizon-100 shapes (n = 498, m = 798), B in
     {1, 8}. Times, bound and plain time at B in {1, 256} (horizon 50) and
     {1, 8} (horizon 100), each beside the streaming kernel on the same
     inputs (the figure before the cluster and split designs); the
     cluster sizes C in {5, 6, 8} at B = 256 and {8, 16} at B = 1, and the
     split kernel's C from 8 to 16 at B = 8 and {8, 16} at B = 1; for
     every C, the wrapper's shared-memory layout against the library's,
     and for every C that fits, its shared bytes per CTA and how many such
     clusters the card holds;
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
     windows of the ramp: one cold step with skipping on and five warm
     steps, all solved, through both split kernel variants; 2 scenarios
     agree with the plain path on the CPU;
  7. mapping get_control: the mapping controller as the agent runs it,
     ``get_control`` at B = 1 on the gentlest window: one cold step and
     five warm steps, all solved, through the split kernel; the cold step
     agrees with the port on the CPU;
  8. closed-loop lap sweep: the repository's closed-loop operating point
     (horizon 50, a real-time-iteration budget of 50 ADMM iterations per
     solve) on the shipped 22 km synth_nordschleife map, B = 256 perturbed
     scenarios through ``LapSweep.run_fused``: one untimed run of 25 steps,
     one timed run (closed-loop solves/s, one cluster launch per step,
     success >= 0.99), 25 more steps split into window, MPC step and
     integration, each ended by a synchronise, whose first step agrees with
     the port on the CPU for 8 scenarios; then the shipped raceline with
     its widths and speed profile (4 scenarios, 10 steps) and
     ``bench/full_lap.run_laps`` at B = 32 for 100 steps;
  9. all-tracks batched solve: ``MultiTrackMPC`` over the 7 racing configs
     at horizon 50 on 7 hairpin windows against the fixture's
     ``multi_track/*``, then ``get_control_grid`` at S = 36 (252
     scenarios): one cold and five warm steps, every scenario solved.
  10. perception: the shipped FPN checkpoint read by the port's msgpack
     reader (parameter count, stored dtype); the IoU gate of
     tests/test_assets.py at 320x192 in fp32 and bf16, the card's fp32
     mask against the port's on the CPU, the bf16 mask against the fp32
     one, and the card's fp32 polylines against the CPU's; the chain-scan
     kernel (csrc/track_chain.cu, on no path) bit-equal to its plain
     version at 1280x736 on masks the sim renders at 16 poses and on four
     adversarial masks scaled up, at bands 4 and 1, both timed; the fused
     chain-edges kernel (csrc/track_chain_edges.cu) bit-equal to its
     plain version (edges and mask) on the same masks and bands, timed in
     turns with the composite of PyTorch ops around the scan kernel and
     with the plain version, beside its bound and its chain floor;
     perception per frame at 1280x736 bf16 (frames chained through the
     mask) with its FPN / extraction split; the camera-to-command loop
     (``bench/perception_loop.perception_in_loop``) for 40 frames: every
     solve solved, the car within the 5 m half width, one chain-edges
     launch per frame and no chain-scan launch, the cluster ADMM kernel
     launched; the loop's launches and busy time per frame under
     ``torch.profiler`` (10 frames);
  11. localisation: the seven configs' localisation blocks parse; the
     monza filter (500 particles) on the card against the CPU from one
     state with one set of scripted draws (a predict, an update on a
     recorded observation, a forced resample; moved resampling draws
     counted), the blind reset's states for all seven maps; 50 predict +
     update pairs and 50 facade step + observe pairs with no host sync
     (``torch.cuda.set_sync_debug_mode("error")``); the replays of
     monza_synth and monza_realperc in full and nordschleife_synth's first
     2,000 steps at filter seeds 0-2, each set passing the statistical
     check against the JAX replays in tests/fixtures/torch_locbench_jax.json
     (``bench/locbench.check``), with the tracker's dispatch times and the
     card's per-observation p50/p99 from CUDA events; and,
     from ``torch.profiler`` over nordschleife's first 200 observations,
     device busy time and launches per observation, the idle share and the
     ``nearest_point`` share.
  12. the racing agent (``bench/agent_loop.py``): the runtime shell's
     three threads (frame, perception worker, control) on the card. (a)
     racing: monza with the shipped FPN at its training camera
     (1280x736 bf16), the 500-particle filter on monza's 11,714-point map
     and the racing MPC at horizon 50, 200 frames paced on solve
     freshness every 4th frame, with tests/test_agent_e2e.py's gates
     (first command within 180 s, > 50 m, off-track < 5 m, > 10 m/s at
     the end, no thread exception, a teardown that joins); at least as
     many cluster launches as racing command sets, at least one
     chain-edges launch, no split launch; 20 more frames under
     ``torch.profiler``. (b) mapping then racing: one mapping lap of
     tests/test_mapping_e2e.py's ~330 m loop with oracle perception at
     320x192 and the mapping MPC at horizon 100, the map built and saved
     (median centre error < 2.5 m, > 0.6 of the true length), the switch
     to the racing MPC at horizon 50 and 100 racing frames (off-track
     < 5 m, > 20 m); the split kernel launched before the switch, the
     cluster kernel after it.
Then the kernels line, the card line and, last, the result line. Any
failure raises and the exit code is not 0. Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import collections
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
# the closed loop (phase 8): scenarios and steps of the sweep, of the
# raceline run and of the full-lap run
SWEEP_BATCH, SWEEP_STEPS = 256, 25
RACELINE_BATCH, RACELINE_STEPS = 4, 10
LAP_BATCH, LAP_STEPS = 32, 100
# the all-tracks grid (phase 9): scenarios per track
GRID_SCENARIOS = 36
# perception (phase 10): sim poses of the chain-scan check, frames of
# the chained per-frame timing, of the loop (bench.py's short form) and
# of its profile
CHAIN_POSES = 16
PERCEPTION_FRAMES = 30
LOOP_FRAMES = 40
PROFILE_FRAMES = 10
# one dependent shared-memory or shuffle round trip of the chain's walk,
# in SM cycles: the floor of a band step
CHAIN_STEP_CYCLES = 30
# the FPN checkpoint's parameter count (params and batch statistics)
FPN_PARAMETERS = 13_057_994
# the IoU gate (tests/test_assets.py) and the mask agreements
IOU_MIN = 0.85
CPU_MASK_AGREE_MIN = 0.999
BF16_MASK_AGREE_MIN = 0.99
# card vs CPU fp32 polylines at 320x192: the masks agree to a few
# pixels, and a flipped edge pixel moves a boundary point, so the fit
# moves by centimetres; a wrong extraction is metres off
POLYLINE_AGREE_M = 0.5
# localisation (phase 11): the replays held against the JAX fixture
# (recording, max_steps) and their filter seeds (the fixture's), and the
# predict + update pairs run with host syncs an error
LOC_REPLAYS = (("monza_synth", None), ("monza_realperc", None), ("nordschleife_synth", 2000))
LOC_SEEDS = (0, 1, 2)
LOC_SYNC_PAIRS = 50
# the racing agent (phase 12): frames of the racing run
AGENT_FRAMES = 200
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
    import concurrent.futures

    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops
    import acmpc_tpu_torch.ops.track_chain as chain
    from acmpc_tpu_torch.ops.cuda_build import BUILD_DIR

    dev = torch.cuda.current_device()
    t0 = time.perf_counter()
    # every source compiles at once: the chunk kernels' three, the chain's two
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(f, dev) for f in (ops._libraries, chain._library, chain._edges_library)]
        for done in builds:
            done.result()
    info = {
        "sources": sorted([*ops.SOURCES.values(), chain.SOURCE, chain.EDGES_SOURCE]),
        "build_s": time.perf_counter() - t0,
    }
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


def _layouts(dev) -> dict:
    """Every cluster size at horizon 50 (cluster kernel) and horizon 100
    (split kernel): the wrapper's layout held against the library's, and
    for every size that fits, its shared bytes per CTA and how many such
    clusters the card holds at once."""
    import ctypes

    import acmpc_tpu_torch.ops.admm_chunk as ops

    libs = ops._libraries(dev)
    out = {"clusters_h50": {}, "splits_h100": {}}
    n, m = H50
    for C in range(1, ops.MAX_CLUSTER + 1):
        smem = ops.cluster_smem_bytes(n, m, C)
        if libs["cluster"].admm_chunk_cluster_smem_bytes(n, m, C) != smem:
            raise RuntimeError(f"C={C}: the wrapper's cluster layout is not the kernel's")
        if smem <= ops.SMEM_PER_BLOCK:
            plan = ops.ChunkPlan("cluster", C, smem)
            out["clusters_h50"][C] = {
                "smem_bytes": smem,
                "max_active_clusters": ops.max_active_clusters(plan, n, m, dev),
            }
    n, m = H100
    for C in range(1, ops.MAX_CLUSTER + 1):
        plan = ops.split_plan(n, m, C)
        lay = ops.split_layout(n, m, C)
        res_w, res_a = ctypes.c_int(), ctypes.c_int()
        libs["split"].admm_chunk_split_resident_rows(
            n, m, C, plan.stages, plan.stage_bytes, ctypes.byref(res_w), ctypes.byref(res_a)
        )
        lib_bytes = libs["split"].admm_chunk_split_smem_bytes(n, m, C, plan.stages, plan.stage_bytes)
        if (lib_bytes, res_w.value, res_a.value) != (lay.bytes, lay.res_w, lay.res_a):
            raise RuntimeError(f"C={C}: the wrapper's split layout is not the kernel's")
        if lay.bytes <= ops.SMEM_PER_BLOCK:
            streamed = 4 * ((lay.rows_w - lay.res_w) * (n + m) + (lay.rows_a - lay.res_a) * n)
            out["splits_h100"][C] = {
                "smem_bytes": lay.bytes,
                "resident_rows_w_a": [lay.res_w, lay.res_a],
                "rows_w_a": [lay.rows_w, lay.rows_a],
                "streamed_bytes_per_cta_iter": streamed,
                "max_active_clusters": ops.max_active_clusters(plan, n, m, dev),
            }
    return out


def phase_kernel() -> dict:
    """Every kernel variant against its plain version on the card, with
    times; the streaming kernel on the same inputs as the figure before
    the cluster design (horizon 50) and before the split design (horizon
    100); and the cluster-size sweeps."""
    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops

    dev = torch.cuda.current_device()
    results = _layouts(dev)
    # cluster sizes timed beside the plan, by shape and batch
    sweep = {
        (H50, 1): [ops.ChunkPlan("cluster", C, ops.cluster_smem_bytes(*H50, C)) for C in (8, 16)],
        (H50, BATCH): [ops.ChunkPlan("cluster", C, ops.cluster_smem_bytes(*H50, C)) for C in (5, 6, 8)],
        (H100, 1): [ops.split_plan(*H100, C) for C in (8, 16)],
        (H100, MAPPING_BATCH): [ops.split_plan(*H100, C) for C in (8, 9, 10, 12, 14, 16)],
    }
    for (n, m), batches in ((H50, (1, 7, BATCH)), (H100, (1, MAPPING_BATCH))):
        stream_plan = ops.ChunkPlan("stream", 1, ops.stream_smem_bytes(n, m))
        for batch in batches:
            inputs = random_chunk_inputs(batch, n, m, seed=batch, device=DEVICE)
            active = torch.arange(batch, device=DEVICE) % 3 != 1
            plan = ops.plan_chunk(n, m, batch)
            timed = ((n, m), batch) in sweep
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
                name = f"admm_chunk_{plan.variant}{'[active]' if masked else ''}"
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
                    # the streaming kernel on the same inputs: the figure
                    # before the cluster and split designs
                    row["stream_max_abs_err"] = compare(run(stream_plan), want, f"{key} stream")
                    row["stream_ms"] = time_cuda_ms(lambda: run(stream_plan), reps=20)
                    row["streaming_bound_ms"] = 1e3 * N_ITERS * n_active * 4 * (
                        n * (n + m) + m * n
                    ) / HBM_BYTES_PER_S
                    if not masked:
                        row["ms_by_C"] = {}
                        for p in sweep[(n, m), batch]:
                            compare(run(p), want, f"{key} C={p.cluster}")
                            row["ms_by_C"][p.cluster] = time_cuda_ms(lambda: run(p), reps=20)
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
    holds whole: a cold step with skipping on, then five warm steps, at
    B = 8."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import SPLIT, SPLIT_ACTIVE, admm_chunk

    mpc = make_mpc("monza", DEVICE, mode="mapping")
    skipping = make_mpc("monza", DEVICE, mode="mapping")
    skipping.admm = dataclasses.replace(skipping.admm, tile_skip=True)
    horizon = mpc.config.horizon
    # the gentlest windows of the ramp
    refs = torch.as_tensor(difficulty_ramp(horizon, BATCH)[:MAPPING_BATCH], device=DEVICE)

    admm_chunk.launches.clear()
    cold, cold_diags = skipping.batched_get_control_fused(mpc.initial_state(MAPPING_BATCH), refs)
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
                f"mapping step {i}: {int((~s.solved).sum())} of {MAPPING_BATCH} unsolved"
            )
        if not bool(torch.isfinite(s.projected_control).all()):
            raise RuntimeError(f"mapping step {i}: commands not finite")
    if steps[-1].projected_control.shape != (MAPPING_BATCH, 2, horizon - 1):
        raise RuntimeError(f"bad command shape {tuple(steps[-1].projected_control.shape)}")
    for name in (SPLIT, SPLIT_ACTIVE):
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
        "solved_per_step": [int(s.solved.sum()) for s in steps],
        "cold_chunks": int(cold_diags.control_iterations.max()) // mpc.admm.check_every,
        "warm_iterations_max": int(diags.control_iterations.max()),
        "launches": launches,
        "warm_ms_per_step": 1e3 * float(np.median(step_s)),
        "warm_step_ms_all": [1e3 * s for s in step_s],
        "cpu_plain_max_abs_err": cpu_err,
        "card": card_line(),
    }
    emit("phase 6 mapping control", info)
    return info


def phase_mapping_single() -> dict:
    """The mapping controller as the agent runs it: ``get_control`` at
    B = 1 on monza's mapping config, a gentle ramp window, one cold step
    and five warm steps."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import SPLIT, admm_chunk

    mpc = make_mpc("monza", DEVICE, mode="mapping")
    horizon = mpc.config.horizon
    ref_np = difficulty_ramp(horizon, BATCH)[0]
    ref = torch.as_tensor(ref_np, device=DEVICE)

    admm_chunk.launches.clear()
    cold, cold_diags = mpc.get_control(mpc.initial_state(), ref)
    steps = [cold]
    step_s, warm_iterations = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, diags = mpc.get_control(steps[-1], ref)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(new)
        warm_iterations.append(int(diags.control_iterations))
    launches = dict(admm_chunk.launches)
    for i, s in enumerate(steps):
        if not bool(s.solved):
            raise RuntimeError(f"mapping get_control step {i} unsolved")
        if not bool(torch.isfinite(s.projected_control).all()):
            raise RuntimeError(f"mapping get_control step {i}: commands not finite")
    if launches.get(SPLIT, 0) == 0:
        raise RuntimeError(f"mapping get_control never launched {SPLIT}")

    cpu_mpc = make_mpc("monza", "cpu", mode="mapping")
    cpu_state, _ = cpu_mpc.get_control(cpu_mpc.initial_state(), torch.as_tensor(ref_np))
    cpu_err = float((cpu_state.projected_control - cold.projected_control.cpu()).abs().max())
    if not bool(cpu_state.solved) or cpu_err > CPU_AGREE_TOL:
        raise RuntimeError(f"mapping get_control: card and CPU disagree: max abs err {cpu_err}")
    info = {
        "config": f"monza mapping, horizon {horizon}, get_control",
        "batch": 1,
        "steps": len(steps),
        "cold_iterations": int(cold_diags.control_iterations),
        "warm_iterations": warm_iterations,
        "launches": launches,
        "warm_ms_per_step": 1e3 * float(np.median(step_s)),
        "warm_step_ms_all": [1e3 * s for s in step_s],
        "cpu_plain_max_abs_err": cpu_err,
        "card": card_line(),
    }
    emit("phase 7 mapping get_control", info)
    return info


def _counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before
    it; returns (its result, the counts just after)."""
    from acmpc_tpu_torch.ops.admm_chunk import admm_chunk
    from acmpc_tpu_torch.ops.track_chain import chain_edges, chain_scan

    admm_chunk.launches.clear()
    chain_scan.launches.clear()
    chain_edges.launches.clear()
    out = fn()
    return out, {**admm_chunk.launches, **chain_scan.launches, **chain_edges.launches}


def _sub_grid(grid, n: int):
    """The first ``n`` scenarios of a sweep grid."""
    return type(grid)(*(getattr(grid, f.name)[:n] for f in dataclasses.fields(grid)))


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def _check_closed_loop(label: str, n_steps: int, launches: dict, rate: float, least: float):
    """One cluster launch per closed-loop step (one RTI chunk per solve)
    and a solve success of at least ``least``."""
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER

    if launches != {CLUSTER: n_steps}:
        raise RuntimeError(f"{label}: expected {n_steps} launches of {CLUSTER}, got {launches}")
    if rate < least:
        raise RuntimeError(f"{label}: solve success {rate} < {least}")


def phase_lap_sweep() -> dict:
    """The closed loop at the repository's operating point on the shipped
    map: the B = 256 sweep (timed, then split per step), its first step on
    the CPU, the raceline run and the full-lap run."""
    import torch

    from acmpc_tpu_torch.bench.full_lap import (
        HALF_WIDTH, MAP, closed_loop_mpc, raceline_sweep, run_laps,
    )
    from acmpc_tpu_torch.bench.lap_step import split_steps
    from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
    from acmpc_tpu_torch.localise.track_map import load_track_map

    dt = 0.1
    mpc = closed_loop_mpc(DEVICE)
    tm = load_track_map(MAP, device=DEVICE)
    sweep = LapSweep(mpc, tm, half_width=HALF_WIDTH, dt=dt)

    def grid_of(batch):
        g = torch.Generator(device=DEVICE).manual_seed(0)
        return SweepGrid.perturbed(g, batch, tm.n_centre, v_max=24.0)

    grid = grid_of(SWEEP_BATCH)
    sweep.run_fused(grid, SWEEP_STEPS)  # untimed: first use of every shape
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        _, metrics = sweep.run_fused(grid, SWEEP_STEPS)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    (metrics, wall), sweep_launches = _counted(timed)
    summary = sweep.summarise(metrics, SWEEP_STEPS)
    _check_closed_loop("sweep", SWEEP_STEPS, sweep_launches, summary["solve_success_rate"], 0.99)
    for k, v in metrics.items():
        if v.shape != (SWEEP_BATCH, SWEEP_STEPS) or not _finite(v):
            raise RuntimeError(f"sweep: metric {k} of shape {tuple(v.shape)} or not finite")

    # the same loop, each piece ended by a synchronise: window argmin
    # (with the warm-start shift and the runtime cap), the MPC step, the
    # integration
    split, first = split_steps(sweep, grid, SWEEP_STEPS)
    step_ms = [sum(parts) for parts in zip(*split.values())]

    # the first step of 8 scenarios through the port on the CPU, from the
    # same cars and states
    (cars0, states0, prev0), (states1, metrics1, i01) = first
    pick = torch.arange(0, SWEEP_BATCH, SWEEP_BATCH // 8, device=DEVICE)

    def rows(tree):
        return type(tree)(*(getattr(tree, f.name)[pick].cpu() for f in dataclasses.fields(tree)))

    cpu_mpc = closed_loop_mpc("cpu")
    cpu_sweep = LapSweep(cpu_mpc, load_track_map(MAP, device="cpu"), half_width=HALF_WIDTH, dt=dt)
    _, cpu_states, cpu_metrics, cpu_i0 = cpu_sweep.fused_step(
        rows(cars0), rows(states0), grid.v_max[pick].cpu(), prev0[pick].cpu()
    )
    if not torch.equal(cpu_i0, i01[pick].cpu()):
        raise RuntimeError("sweep: card and CPU windows differ")
    cpu_err = max(
        float((cpu_states.projected_control - states1.projected_control[pick].cpu()).abs().max()),
        float((cpu_metrics["v"] - metrics1["v"][pick].cpu()).abs().max()),
    )
    if not bool(cpu_states.solved.all()) or cpu_err > CPU_AGREE_TOL:
        raise RuntimeError(f"sweep: card and CPU disagree: max abs err {cpu_err}")

    # the shipped raceline with its widths and speed profile
    rsweep, rgrid = raceline_sweep(mpc, tm, _sub_grid(grid, RACELINE_BATCH), dt)
    raceline, raceline_launches = _counted(lambda: run_laps(rsweep, rgrid, dt, RACELINE_STEPS))
    if raceline["total_solves"] != RACELINE_BATCH * RACELINE_STEPS:
        raise RuntimeError(f"raceline: {raceline['total_solves']} solves")
    _check_closed_loop("raceline", RACELINE_STEPS, raceline_launches, raceline["solve_success_rate"], 0.9)

    # the full-lap tool's loop at B = 32
    laps, lap_launches = _counted(lambda: run_laps(sweep, grid_of(LAP_BATCH), dt, LAP_STEPS))
    if laps["sequential_solves_per_scenario"] != LAP_STEPS:
        raise RuntimeError(f"full lap: {laps['sequential_solves_per_scenario']} sequential solves")
    _check_closed_loop("full lap", LAP_STEPS, lap_launches, laps["solve_success_rate"], 0.99)

    launches = collections.Counter()
    for counts in (sweep_launches, raceline_launches, lap_launches):
        launches.update(counts)
    info = {
        "config": "closed loop: horizon 50, RTI 50 iterations, synth_nordschleife, half width 4.5",
        "map_points": tm.n_centre,
        "batch": SWEEP_BATCH,
        "steps": SWEEP_STEPS,
        "closed_loop_solves_per_s": SWEEP_BATCH * SWEEP_STEPS / wall,
        "wall_s": wall,
        "summary": summary,
        "split_step_ms_median": float(np.median(step_ms)),
        "split_step_ms_all": step_ms,
        **{f"{k}_median": float(np.median(v)) for k, v in split.items()},
        **split,
        "cpu_plain_max_abs_err": cpu_err,
        "raceline": raceline,
        "full_lap": laps,
        "launches_sweep": sweep_launches,
        "launches_raceline": raceline_launches,
        "launches_full_lap": lap_launches,
        "launches": dict(launches),
        "card": card_line(),
    }
    emit("phase 8 closed-loop lap sweep", info)
    return info


def phase_multi_track() -> dict:
    """The 7 racing configs in one batched solve against the fixture,
    then the (S, T) grid at S = 36."""
    import torch

    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.geometry.tracks import get_hairpin_track, with_widths
    from acmpc_tpu_torch.mpc.multi_track import MultiTrackMPC
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER

    agent = [load_config(ROOT / "configs" / f"{t}.yaml") for t in TRACKS]
    configs = [dataclasses.replace(c.racing_control, horizon=HORIZON) for c in agent]
    model = SpatialBicycleModel(
        agent[0].vehicle, configs[0].constraints.v_min, configs[0].constraints.v_max
    )
    mt = MultiTrackMPC(SpatialMPC(configs[0], model, device=DEVICE), configs)
    caps = torch.tensor(
        [min(30.0, c.unlocalised_max_speed or 30.0) for c in configs], device=DEVICE
    )

    def hairpins(extra):
        return np.stack([
            with_widths(get_hairpin_track(40.0 + 5 * t + extra, HORIZON)) for t in range(len(TRACKS))
        ]).astype(np.float32)

    golden = np.load(ROOT / "tests" / "fixtures" / "golden_controls.npz")
    (out, _), fixture_launches = _counted(
        lambda: mt.get_control(mt.initial_states(), hairpins(0.0), v_max_runtime=caps)
    )
    if not np.array_equal(out.solved.cpu().numpy(), golden["multi_track/solved"]):
        raise RuntimeError("multi-track: solved flags differ from the fixture")
    worst = 0.0
    for field in ("projected_control", "cum_time"):
        got = getattr(out, field).cpu().numpy()
        want = golden[f"multi_track/{field}"]
        np.testing.assert_allclose(got, want, rtol=GOLDEN_TOL, atol=GOLDEN_TOL, err_msg=field)
        worst = max(worst, float(np.abs(got - want).max()))

    S = GRID_SCENARIOS
    refs = torch.as_tensor(np.stack([hairpins(2.0 * s) for s in range(S)]), device=DEVICE)
    v_grid = caps.expand(S, len(TRACKS))

    def grid_steps():
        cold, _ = mt.get_control_grid(mt.initial_states(n_scenarios=S), refs, v_grid)
        steps, step_s = [cold], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, diags = mt.get_control_grid(steps[-1], refs, v_grid)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            steps.append(new)
        return steps, step_s, diags

    (steps, step_s, diags), grid_launches = _counted(grid_steps)
    for i, s in enumerate(steps):
        if not bool(s.solved.all()):
            raise RuntimeError(f"grid step {i}: {int((~s.solved).sum())} of {S * len(TRACKS)} unsolved")
        if not _finite(s.projected_control):
            raise RuntimeError(f"grid step {i}: commands not finite")
    for label, counts in (("fixture", fixture_launches), ("grid", grid_launches)):
        if counts.get(CLUSTER, 0) == 0 or set(counts) != {CLUSTER}:
            raise RuntimeError(f"multi-track {label}: expected launches of {CLUSTER}, got {counts}")
    warm_ms = 1e3 * float(np.median(step_s))
    launches = collections.Counter(fixture_launches)
    launches.update(grid_launches)
    info = {
        "config": f"{len(TRACKS)} racing configs, horizon {HORIZON}",
        "golden_max_abs_err": worst,
        "tolerance": GOLDEN_TOL,
        "grid": [S, len(TRACKS)],
        "grid_warm_ms_per_step": warm_ms,
        "grid_warm_step_ms_all": [1e3 * s for s in step_s],
        "grid_solves_per_s": S * len(TRACKS) / (warm_ms / 1e3),
        "grid_warm_iterations_max": int(diags.control_iterations.max()),
        "launches_fixture": fixture_launches,
        "launches_grid": grid_launches,
        "launches": dict(launches),
        "card": card_line(),
    }
    emit("phase 9 all-tracks batched solve", info)
    return info


def _iou(pred: np.ndarray, truth: np.ndarray) -> float:
    pred, truth = pred == 1, truth.astype(bool)
    return float((pred & truth).sum() / max((pred | truth).sum(), 1))


def _chain_bound(rows: int, width: int) -> tuple[float, str]:
    """Least time of one chain-scan launch on an H100: its rows read once
    and its selection written once (a byte each), against about eight
    integer operations per pixel (run id, seed, stamp, select, store) at
    the fp32 rate; returns (ms, "bytes" | "operations")."""
    t_bytes = 2 * rows * width / HBM_BYTES_PER_S
    t_ops = 8 * rows * width / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _edges_bound(height: int, width: int, with_mask: bool) -> tuple[float, str]:
    """Least time of one chain-edges launch on an H100: the mask read once
    (a byte a pixel), each row's left and right (int64) and valid (bool)
    written once, and the selected mask when asked, against about eight
    integer operations per pixel at the fp32 rate; returns (ms, "bytes" |
    "operations")."""
    n_bytes = height * width * (2 if with_mask else 1) + 17 * height
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 8 * height * width / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sm_clocks_mhz() -> dict:
    """The card's current and maximum SM clock (nvidia-smi), in MHz."""
    now, most = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0].split(",")
    return {"sm_clock_mhz": float(now), "max_sm_clock_mhz": float(most)}


def phase_perception() -> dict:
    """Perception on the card: checkpoint, IoU gate, chain-scan kernel
    against its plain version at 1280x736, the per-frame time and the
    camera-to-command loop."""
    import torch

    from acmpc_tpu_torch.bench import chain_stages
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.bench.full_lap import closed_loop_mpc
    from acmpc_tpu_torch.localise.track_map import TrackMap
    from acmpc_tpu_torch.models.checkpoint import read_checkpoint
    from acmpc_tpu_torch.ops import track_chain as chain
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import scan_rows
    from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

    t_phase = time.perf_counter()
    info: dict = {}

    # 1. the shipped checkpoint through the port's reader
    cfg = loop.perception_config()  # 1280x736, bf16, training camera
    variables = read_checkpoint(ROOT / cfg.model_path)
    leaves, stack = [], [variables]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                leaves.append(v)
    n_params = int(sum(v.size for v in leaves))
    stored = sorted({str(v.dtype) for v in leaves})
    if n_params != FPN_PARAMETERS:
        raise RuntimeError(f"checkpoint holds {n_params} parameters, not {FPN_PARAMETERS}")
    info["checkpoint"] = {"parameters": n_params, "stored_dtypes": stored, "leaves": len(leaves)}

    # 2. the IoU gate of tests/test_assets.py: the same 800-point track,
    # camera and start, 320x192
    theta = np.linspace(0, 2 * np.pi, 800, endpoint=False)
    r = 160.0 + 25.0 * np.sin(2 * theta)
    ring = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    d = np.roll(ring, -1, axis=0) - ring
    t = d / np.linalg.norm(d, axis=1, keepdims=True)
    nrm = np.stack([-t[:, 1], t[:, 0]], axis=1)
    tm = TrackMap(*(torch.tensor(v, dtype=torch.float32) for v in (ring, ring + 5 * nrm, ring - 5 * nrm)))
    cam = CameraInfo(width=320, height=192, vertical_fov_deg=60.0, position=[0.0, 0.0, 1.2], pitch_deg=9.0)
    small_sim = SyntheticSimulator(tm, cam, half_width=5.0, start_index=123)
    truth = small_sim.render_drivable_mask()
    image = small_sim.render_camera_image(truth)
    small = dataclasses.replace(
        cfg, image_width=320, image_height=192, n_rows_to_remove_bonnet=160, n_polyfit_points=200
    )
    masks, centres = {}, {}
    for label, precision, device in (("fp32", "fp32", DEVICE), ("bf16", "bf16", DEVICE), ("cpu_fp32", "fp32", "cpu")):
        perc = Perceiver(dataclasses.replace(small, precision=precision), variables, device)
        drivable, _, tracks = perc._run_pipeline(torch.as_tensor(image, device=device))
        masks[label] = drivable.cpu().numpy()
        centres[label] = tracks["centre"].cpu().numpy()
    iou = {k: _iou(masks[k], truth) for k in ("fp32", "bf16")}
    cpu_agree = float((masks["fp32"] == masks["cpu_fp32"]).mean())
    bf16_agree = float((masks["bf16"] == masks["fp32"]).mean())
    centre_err = float(np.abs(centres["fp32"] - centres["cpu_fp32"]).max())
    if min(iou.values()) <= IOU_MIN:
        raise RuntimeError(f"shipped model IoU {iou} <= {IOU_MIN}")
    if cpu_agree < CPU_MASK_AGREE_MIN or bf16_agree < BF16_MASK_AGREE_MIN:
        raise RuntimeError(f"masks disagree: card/CPU fp32 {cpu_agree}, bf16/fp32 {bf16_agree}")
    for label, c in centres.items():
        if c.shape != (small.n_polyfit_points, 2) or not np.isfinite(c).all():
            raise RuntimeError(f"{label}: centreline of shape {c.shape} or not finite")
    if centre_err > POLYLINE_AGREE_M:
        raise RuntimeError(f"card and CPU centrelines differ by {centre_err} m")
    info["iou_gate"] = {
        "resolution": "320x192",
        "iou": iou,
        "mask_agree_card_cpu_fp32": cpu_agree,
        "mask_agree_bf16_fp32": bf16_agree,
        "centre_max_abs_err_card_cpu_m": centre_err,
    }

    # 3. the chain-scan kernel against its plain version at 1280x736
    H, W = cfg.image_height, cfg.image_width
    centre, left, right, lap_m = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    cases = [(f"sim{k}", m, cfg.n_rows_to_remove_bonnet) for k, m in enumerate(loop.sim_masks(sim, centre, CHAIN_POSES))]
    adversarial, bonnet = loop.adversarial_masks(H, W)
    cases += [(name, m, bonnet) for name, m in adversarial.items()]
    checked, selected, max_err = 0, 0, 0
    timing_rows = {}
    for name, mask_np, bonnet_row in cases:
        mask = torch.as_tensor(mask_np, device=DEVICE)
        for band in (4, 1):
            _, rows, gap = scan_rows(mask, bonnet_row, band=band)
            got = chain.chain_scan(rows, gap)
            want = chain.chain_scan_reference(rows, gap)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise RuntimeError(f"chain scan {name} band {band}: {bad} pixels differ from the plain version")
            checked += 1
            selected += int(got.sum())
            max_err = max(max_err, int((got.int() - want.int()).abs().max()))
            if name == "sim0":
                timing_rows[band] = (rows, gap)
    chain_timing = {}
    for band, (rows, gap) in timing_rows.items():
        n = rows.shape[0]
        bound_ms, bound_by = _chain_bound(n, W)
        chain_timing[f"band{band}"] = {
            "rows": n,
            "ms": time_cuda_ms(lambda: chain._launch(rows, gap), reps=50),
            "plain_ms": time_cuda_ms(lambda: chain.chain_scan_reference(rows, gap), reps=3),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
    info["chain_scan"] = {
        "resolution": f"{W}x{H}",
        "masks": len(cases),
        "comparisons_bit_equal": checked,
        "pixels_selected": selected,
        "max_abs_err": max_err,
        **chain_timing,
    }

    # 3b. the fused chain-edges kernel against its plain version, edges
    # and mask, on the same masks and bands
    checked, edges_err = 0, 0
    for name, mask_np, bonnet_row in cases:
        mask = torch.as_tensor(mask_np, device=DEVICE)
        for band in (4, 1):
            got = chain.chain_edges(mask, bonnet_row, 3, band, return_mask=True)
            want = chain.chain_edges_reference(mask, bonnet_row, 3, band, return_mask=True)
            torch.cuda.synchronize()
            for label, g, w in zip(("left", "right", "valid", "mask"), got, want):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    bad = int((g.long() != w.long()).sum()) if g.shape == w.shape else "shape"
                    raise RuntimeError(f"chain edges {name} band {band}: {label} differs from the plain version ({bad})")
                edges_err = max(edges_err, int((g.long() - w.long()).abs().max()))
            checked += 1
    # timed on sim0 in turns: fused kernel, the composite around the scan
    # kernel, the plain version, then back
    mask = torch.as_tensor(cases[0][1], device=DEVICE)
    bonnet_row = cases[0][2]
    edges_timing = {}
    for band in (4, 1):
        runs = {
            "ms": (lambda: chain._launch_edges(mask, bonnet_row, 3, band, False), 100),
            "composite_ms": (lambda: chain.chain_edges_reference(mask, bonnet_row, 3, band, scan=chain._launch), 50),
            "plain_ms": (lambda: chain.chain_edges_reference(mask, bonnet_row, 3, band), 2),
        }
        turns = {key: [] for key in runs}
        for key in [*runs, *reversed(runs)]:
            fn, reps = runs[key]
            turns[key].append(time_cuda_ms(fn, reps=reps))
        clocks = sm_clocks_mhz()
        walked = chain_stages.bands_walked(mask, bonnet_row, band)
        bound_ms, bound_by = _edges_bound(H, W, with_mask=False)
        edges_timing[f"band{band}"] = {
            **{key: sum(t) / len(t) for key, t in turns.items()},
            "turns_ms": turns,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bands_walked": walked,
            "chain_floor_ms": walked * CHAIN_STEP_CYCLES / (clocks["max_sm_clock_mhz"] * 1e3),
            **clocks,
        }
    info["chain_edges"] = {
        "resolution": f"{W}x{H}",
        "masks": len(cases),
        "comparisons_bit_equal": checked,
        "max_abs_err": edges_err,
        **edges_timing,
    }

    # 4. perception per frame at 1280x736 bf16, chained through the mask
    perc = Perceiver(cfg, variables, DEVICE)
    info["per_frame"] = loop.perception_fps(perc, frames=PERCEPTION_FRAMES)

    # 5. the camera-to-command loop
    mpc = closed_loop_mpc(DEVICE)
    run, launches = _counted(lambda: loop.perception_in_loop(perc, mpc, sim, centre, lap_m, LOOP_FRAMES))
    if run["solve_success"] != 1.0:
        raise RuntimeError(f"perception loop: solve success {run['solve_success']}")
    if not run["max_offtrack_m"] < loop.HALF_WIDTH:
        raise RuntimeError(f"perception loop: the car left the track by {run['max_offtrack_m']} m")
    # one fused extraction per frame, plus the untimed warm frame; the scan
    # kernel is on no path
    if launches.get(chain.TRACK_CHAIN_EDGES, 0) != run["frames"] + 1 or chain.TRACK_CHAIN_SCAN in launches:
        raise RuntimeError(f"perception loop: chain launches {launches} for {run['frames']} + 1 frames")
    if launches.get(CLUSTER, 0) == 0:
        raise RuntimeError(f"perception loop never launched {CLUSTER}: {launches}")
    info["loop"] = run
    info["launches"] = launches
    # the loop's launches and busy time per frame
    profile = loop.profile_loop(perc, mpc, sim, frames=PROFILE_FRAMES)
    info["loop_profile"] = {k: v for k, v in profile.items() if not isinstance(v, list) or k == "top_kernels_ms_per_frame"}
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 10 perception", info)
    return info


def phase_localisation() -> dict:
    """The particle filter on the card: configs, card against CPU, no host
    sync, the replays against the JAX fixture, times and the profile."""
    from acmpc_tpu_torch.bench import locbench
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.config.schema import LocalisationConfig

    t_phase = time.perf_counter()
    info: dict = {}
    # 1. the seven configs' localisation blocks
    configs = {t: load_config(ROOT / "configs" / f"{t}.yaml").localisation for t in TRACKS}
    for track, cfg in configs.items():
        if not isinstance(cfg, LocalisationConfig) or cfg.n_particles <= 0:
            raise RuntimeError(f"{track}: localisation block parsed to {cfg!r}")
    info["configs"] = {t: [c.n_particles, c.max_observation_points, c.localised_max_error] for t, c in configs.items()}

    # 2. card against CPU, one call each from one state, the same draws
    agree = locbench.devices_agree()
    n_particles = configs["monza"].n_particles
    for call, row in agree.items():
        allowed = locbench.MOVED_DRAWS_MAX_SHARE * n_particles if call == "resample" else 0
        if row["moved"] > allowed or not (row["valid_equal"] and row["converged_equal"]):
            raise RuntimeError(f"card and CPU {call} disagree: {row}")
    # the reset's centreline indices are one host array on both devices
    # (particle_filter.reset_indices); its states are computed on each
    reset = locbench.reset_states_agree(TRACKS)
    for track, row in reset.items():
        if row["max_xy_m"] > locbench.CARD_CPU_XY_M or row["max_yaw_rad"] > locbench.CARD_CPU_YAW_RAD:
            raise RuntimeError(f"{track}: card and CPU resets disagree: {row}")
    info["card_vs_cpu"] = {**agree, "reset_states": reset}

    # 3. no host sync
    info["sync_free"] = locbench.sync_free(pairs=LOC_SYNC_PAIRS)

    # 4, 5. the replays against the fixture, at its three seeds, with
    # their times
    fixture = locbench.load_fixture()
    info["replays"] = {}
    for recording, max_steps in LOC_REPLAYS:
        rows = [locbench.replay(recording, seed, max_steps, DEVICE) for seed in LOC_SEEDS]
        fails = locbench.check(rows, fixture)
        if fails:
            raise RuntimeError(f"{recording} replays outside the JAX fixture's bounds: {fails}; {rows}")
        info["replays"][f"{recording}/{max_steps or 'all'}"] = {
            "seeds_inside": locbench.seeds_inside(rows, fixture),
            "rows": rows,
        }
    info["profile"] = locbench.profile(device=DEVICE)
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 11 localisation", info)
    return info


def phase_agent() -> dict:
    """The racing agent on the card: the racing run at full width, then
    the mapping session and its switch to racing, each with its gates;
    the launches of the three paths' kernels, summed over both runs."""
    from acmpc_tpu_torch.bench import agent_loop

    t_phase = time.perf_counter()
    info: dict = {}
    for name, run in (
        ("racing", lambda: agent_loop.racing_run(AGENT_FRAMES, DEVICE, profile=True)),
        ("mapping", lambda: agent_loop.mapping_run(DEVICE)),
    ):
        result = run()
        if result["fails"]:
            raise RuntimeError(f"agent {name} run failed its gates: {result['fails']}; {result}")
        info[name] = result
    launches = collections.Counter(info["racing"]["launches"])
    for part in ("mapping", "racing"):
        launches.update(info["mapping"][part]["launches"])
    info["launches"] = dict(launches)
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 12 agent", info)
    return info


def kernels_line(
    kernel: dict, main: dict, mapping: dict, sweep: dict, multi: dict, perception: dict, agent: dict
) -> dict:
    """One row per kernel variant: launches from the paths that run it
    (cluster: phases 4, 8, 9, 10 and 12; split: phases 6 and 12; stream:
    none since the split kernel, so the count from phase 6 is 0; chain
    edges: phase 10's loop and phase 12; chain scan: none since the
    chain-edges kernel, so the count from phase 10's loop is 0), numbers
    from phase 3 at the horizon-50
    B = 256 or the mapping shapes (stream: at the mapping shapes, on the
    split kernel's inputs), and for both chain kernels from phase 10 at
    1280x736, band 4."""
    import acmpc_tpu_torch.ops.admm_chunk as ops
    import acmpc_tpu_torch.ops.track_chain as chain

    def row(name, key, line, path, prefix=""):
        r = kernel[key]
        variant = name.removeprefix("admm_chunk_").removesuffix("[active]")
        return {
            "name": name,
            "route": "cuda",
            "source": f"acmpc_tpu_torch/csrc/{ops.SOURCES[variant]}",
            "replaces": f"acmpc_tpu/ops/pallas_admm.py:{line}",
            "launches": path["launches"].get(name, 0),
            "max_abs_err": r[f"{prefix}max_abs_err"],
            "ms": r[f"{prefix}ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }

    n50, n100 = H50[0], H100[0]
    h50, h50a = f"n{n50}_B{BATCH}", f"n{n50}_B{BATCH}_active"
    h100, h100a = f"n{n100}_B{MAPPING_BATCH}", f"n{n100}_B{MAPPING_BATCH}_active"
    cluster_paths = collections.Counter(agent["launches"])
    for path in (main, sweep, multi, perception):
        cluster_paths.update(path["launches"])
    cluster_paths = {"launches": cluster_paths}
    split_paths = {"launches": collections.Counter(mapping["launches"]) + collections.Counter(agent["launches"])}
    scan = perception["chain_scan"]["band4"]
    edges = perception["chain_edges"]["band4"]
    return {
        "kernels": [
            row(ops.CLUSTER, h50, 99, cluster_paths),
            row(ops.CLUSTER_ACTIVE, h50a, 103, cluster_paths),
            row(ops.SPLIT, h100, 99, split_paths),
            row(ops.SPLIT_ACTIVE, h100a, 103, split_paths),
            row(ops.STREAM, h100, 99, mapping, prefix="stream_"),
            row(ops.STREAM_ACTIVE, h100a, 103, mapping, prefix="stream_"),
            {
                "name": chain.TRACK_CHAIN_SCAN,
                "route": "cuda",
                "source": f"acmpc_tpu_torch/csrc/{chain.SOURCE}",
                "replaces": "acmpc_tpu/perception/tracks.py:121",
                "launches": perception["launches"].get(chain.TRACK_CHAIN_SCAN, 0),
                "max_abs_err": perception["chain_scan"]["max_abs_err"],
                "ms": scan["ms"],
                "plain_ms": scan["plain_ms"],
                "bound_ms": scan["bound_ms"],
                "bound_by": scan["bound_by"],
                "library_ms": None,
            },
            {
                "name": chain.TRACK_CHAIN_EDGES,
                "route": "cuda",
                "source": f"acmpc_tpu_torch/csrc/{chain.EDGES_SOURCE}",
                "replaces": "acmpc_tpu/perception/tracks.py:62",
                "launches": perception["launches"].get(chain.TRACK_CHAIN_EDGES, 0)
                + agent["launches"].get(chain.TRACK_CHAIN_EDGES, 0),
                "max_abs_err": perception["chain_edges"]["max_abs_err"],
                "ms": edges["ms"],
                "plain_ms": edges["plain_ms"],
                "bound_ms": edges["bound_ms"],
                "bound_by": edges["bound_by"],
                "library_ms": None,
            },
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
    phase_mapping_single()
    sweep = phase_lap_sweep()
    multi = phase_multi_track()
    perception = phase_perception()
    phase_localisation()
    agent = phase_agent()
    print(json.dumps(kernels_line(kernel, main_info, mapping, sweep, multi, perception, agent)))
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
