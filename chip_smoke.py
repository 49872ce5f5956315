#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``acmpc_tpu_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing one line:
  1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     TF32 flags (must be off), CUDA 12.4 or later in PyTorch's build and
     the driver (conditional WHILE nodes);
  2. build: compiles the five kernel sources (csrc/admm_chunk.cu, the
     cluster kernel; csrc/admm_chunk_split.cu, the split kernel;
     csrc/track_chain_edges.cu, the fused chain-edges kernel;
     csrc/graph_loop.cu, the device loop's condition kernel, which
     checks for CUDA 12.4; and csrc/ruiz_equilibrate.cu, Ruiz scaling)
     side by side with nvcc into
     build/torch_kernels/, and prints what ptxas reports of each kernel
     (registers, spills);
  3. kernel: each variant against the plain PyTorch version on random
     operators, with and without a mixed ``active`` mask. On dense
     operators: the cluster
     kernel at the horizon-50 shapes (n = 248, m = 398), B in {1, 7, 256};
     the split kernel at the horizon-100 shapes (n = 498, m = 798), B in
     {1, 8}. Times, bound and plain time at B in {1, 256} (horizon 50) and
     {1, 8} (horizon 100); the cluster sizes C in {5, 6, 8} at B = 256
     and {8, 16} at B = 1, and the split kernel's C from 8 to 16 at B = 8
     and {8, 16} at B = 1; for
     every C, the wrapper's shared-memory layout against the library's,
     and for every C that fits, its shared bytes per CTA and how many such
     clusters the card holds. On the box block (the main path's QPs, whose A is [A_d; I]:
     the control QP on ramp windows, the raceline's first QP; the operator
     W_s = [K^-1 | K^-1 A_d'], A_d and g): each planned variant against
     both plain versions (the box block's, and the dense one on the dense
     operator of the same QP) at horizon 50 (B 1, 7, 256; the cluster
     kernel at C = 8 or 3), horizon 100 (B 1, 8; cluster, C = 10) and
     the raceline's 586 (cluster; the raceline CLI's cap on monza) and
     1,953 points (split; monza at the stride of the shipped racelines),
     with its ms,
     the plain version's, both bounds (the dense operator's and the box
     block's), both operators' bytes, the dense kernel's ms on the dense
     operator of the same QP, and the other cluster sizes; every box
     layout against the library's, with the clusters the card holds.
     The Ruiz kernel (ops/ruiz.py) on the main path's QPs at horizon 50
     (B 1, 256) and 100 (B 1), 5 passes, and the 1,953-point raceline
     (B 1, streamed), 10 passes: one launch, within 1e-5 relative of the
     plain version, ms, bound and the plain version's ms;
     its layouts against the library's (every phase that counts launches
     with ``_counted`` also wants one Ruiz launch a solve);
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
     steps, all solved, through both box-block cluster variants (C = 10);
     2 scenarios agree with the plain path on the CPU;
  7. mapping get_control: the mapping controller as the agent runs it,
     ``get_control`` at B = 1 on the gentlest window: one cold step and
     five warm steps, all solved, through the box-block cluster kernel;
     the cold step agrees with the port on the CPU;
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
     one, and the card's fp32 polylines against the CPU's; the fused
     chain-edges kernel (csrc/track_chain_edges.cu) bit-equal to its
     plain version (edges and mask) at 1280x736 on masks the sim renders
     at 16 poses and on four adversarial masks scaled up, at bands 4 and
     1, timed in turns with the plain version, beside its bound and its
     chain floor;
     perception per frame at 1280x736 bf16 (frames chained through the
     mask) with its FPN / extraction split; the camera-to-command loop
     (``bench/perception_loop.perception_in_loop``) for 40 frames: every
     solve solved, the car within the 5 m half width, one chain-edges
     launch per frame, the cluster ADMM kernel
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
     many box-block cluster launches as racing command sets, at least one
     chain-edges launch, no other chunk kernel; 20 more frames under
     ``torch.profiler``. (b) mapping then racing: one mapping lap of
     tests/test_mapping_e2e.py's ~330 m loop with oracle perception at
     320x192 and the mapping MPC at horizon 100, the map built and saved
     (median centre error < 2.5 m, > 0.6 of the true length), the switch
     to the racing MPC at horizon 50 and 100 racing frames (off-track
     < 5 m, > 20 m); the box-block cluster kernel launched before the
     switch (C = 10) and after it, and no other chunk kernel.
  13. the offline tools and the dashboard: (a) the minimum-curvature
     raceline (``utils/raceline.py``) on each of the seven shipped maps at
     the raceline CLI's 600-point cap and on monza at 1,953 points, each
     held against the JAX package's line in
     tests/fixtures/torch_raceline_jax.npz with tests/test_torch_raceline.py's
     tolerances (the curvature profile and its squared sum, alpha within
     the margin, the bound), every QP solved, and every chunk a launch of the
     planned box-block kernel (a cluster up to 942 points, the split kernel at
     1,953) and of no other variant; ms per raceline and chunks per QP;
     (b) the Pacejka model's 40-step rollouts and curve fits on the card
     against the CPU; (c) phase 12's racing run (monza, 1280x736 bf16,
     500 particles) for 60 frames with the dashboard served and a client
     thread watching the composite and every feed over HTTP: every
     stream's frames whole JPEGs, ``/session.json`` parsed, no render
     exception; the agent's solves/s and ``behaviour()`` p50/p99 beside
     phase 12's, and the composite's encode ms; (d) the localisation CLI
     (``cli/benchmark_localisation``) on the committed recording with the
     fewest control steps (vallelunga_synth, 2,730), filter seeds 0-2 in
     turn until one lies inside the JAX fixture's bounds, held with
     ``bench/locbench.check``. The map
     viewer and the CLIs' ``--figure`` and ``--plot`` need matplotlib,
     which the card machine lacks; this phase does not run them.
  14. the parallel layer (``parallel/``, ``cli/launch_pod.py``, the
     horizon-sharded speed profiles): (a) an NCCL process group of one
     rank, made and destroyed in the phase: ``sharded_get_control`` on
     phase 4's inputs (one cold step with skipping, five warm), 256 of 256
     solved a step, equal to ``batched_get_control_fused`` on the same
     inputs, both cluster variants launched, and the sharded map profile
     on synth_nordschleife's 43,940 centre points equal to the unsharded
     one; (b) two ranks sharing the card over gloo, spawned by the phase
     (``bench/pod_sweep.py``): ``sharded_lap_sweep`` at the launch CLI's
     operating point (synth_nordschleife, 32 scenarios a rank, 25 steps,
     horizon 50, RTI 50), one cluster launch a step on each rank,
     64 x 25 solves at a success of at least 0.99, speeds within
     tests/test_torch_lap_sweep.py's LOOP_TOL of one process's
     ``run_fused`` on the same 64 scenarios, closed-loop solves/s of both;
     then the launch CLI as two gloo ranks (``run_two_process_smoke``), the
     sweep and ``--full-lap`` for 300 steps at one scenario a rank, checked
     as tests/test_multiprocess_distributed.py checks JAX's; (c) in the
     same two ranks, the sharded exact map profile (monza's map limits) on
     synth_nordschleife's and monza's maps within the 2 ulps of the
     unsharded one that tests/test_torch_parallel.py states, and the
     sharded ADMM profile at 2,048 points in the unsharded one's
     iterations, within 1e-3 / 2e-3; walls, iterations, a collective's cost;
     (d) the ops alone on the card against the CPU, with times, launches,
     bounds: PCR at N = 43,940, the SPIKE solve at two ranks, and
     ``spd_inverse`` on the (256, 248, 248) KKT matrices of phase 4's
     inputs beside the Cholesky route (``_factor``) on the same matrices.
  15. the vmapped control step (``solve_box_qp`` over a scenario axis):
     (a) phase 4's inputs through ``SpatialMPC.batched_get_control``, one
     cold and five warm steps, every scenario solved, both cluster
     variants launched; 8 lanes picked by stride against ``get_control``
     alone on the card (status and iterations equal, commands within
     CPU_AGREE_TOL), every lane against ``batched_get_control_fused``
     (5e-3, ``n_solved`` equal), 8 lanes against the CPU (5e-3); the wall
     a step; (b) 64 random QPs at n = 248, m = 398 with adaptive rho,
     each lane against its unbatched solve on the card (status equal, x
     within 2e-2 of the scale), the lanes that refactored; (c) the mapping
     control (horizon 100) at B = 8 on the box-block cluster kernel, every lane
     against ``get_control``; (d) ``LapSweep.run`` on phase 8's grid
     against ``run_fused`` (metrics within 5e-3, ``solved`` equal, one
     cluster launch a step), closed-loop solves/s of both, timed in
     turns; (e) ``make_mesh(1)`` at two gloo ranks sharing the card
     (``bench/pod_sweep.py``'s submesh case): rank 0's
     ``sharded_get_control`` against ``batched_get_control``, rank 1
     holding no rows and its collective raising.
  16. the segmenter's training (``cli/train_segmenter.py``; no kernel of
     its own: cuDNN's fp32 convolutions with TF32 off): (a) one step at
     192x320, batch 2, on the card against the CPU from the same
     variables (the trainer's start, Flax's draws for ``PRNGKey(0)``, and
     one drawn with a ``torch.Generator``): the loss, every leaf's
     gradient (the BatchNorm statistics included) and every leaf after
     the AdamW step, with ``bench/train_step.py``'s tolerances, and each
     side's gradients against an fp64 step (reported); (b) ``main`` at the JAX tool's
     defaults (seed 0, 300 steps, batch 16, lr 3e-4): the loss and val
     IoU every 50 steps and at the last, the final val IoU above 0.9, the
     host's frame sampling and the device step a step (CUDA events), ten
     synchronised steps, images/s, peak memory, the FLOPs of a step
     (``FlopCounterMode``) against XLA's count and the fp32 bound, and 20
     steps of the training loop under ``torch.profiler`` (busy share);
     (c) the checkpoint it wrote (fp16, Flax layout) loaded by
     ``TrackSegmenter`` at 1280x736 in fp32 and bf16, IoU above 0.85 on 8
     sim frames (the shipped checkpoint's beside it), then the
     camera-to-command loop on it for 40 frames, gated as phase 10's; the
     shipped checkpoint's SHA-256 the same before and after.
  17. the compiled entries (``ops/graph_loop.py``, ``csrc/graph_loop.cu``):
     the loop kernel's row (a ``device_while`` counting to 1,000 captured:
     the trips it counted and its launches exact, ms a trip against the
     host loop's); 200 closed-loop B = 1 steps on monza's map
     (``bench/graph_entries.py``) of the racing control (horizon 50) and
     of the mapping control (horizon 100) through ``jitted_get_control``
     against ``get_control``, state carried, every step's state,
     diagnostics and window index bit-equal, with a step that runs to
     ``max_iter`` and one that fails, and every run's launches exact (a
     chunk a launch; the loop kernel once a replay and once a chunk); the
     golden battery through ``jitted_get_control`` within 5e-3; three
     replays under ``torch.cuda.set_sync_debug_mode("error")``; a capture
     that reads the card raising; the perceiver's graph against eager at
     1280x736 bf16 on 8 sim frames, bit-equal, and ``TrackSegmenterAOT``
     against the eager forward on them; then eager against
     captured in turns on two fixed CPU cores, 500 steps or frames each:
     wall p50/p99, host syncs, launches, busy and idle share a call,
     chunks a step, capture seconds and the graph's pool. Phases 10, 12
     and 16 run the captured entries too (the loop's frame is
     ``_pipeline`` then ``jitted_get_control``; the agent's control
     thread calls ``jitted_get_control``, its oracle path ``jitted()``).
  18. SegFormer-B2 (``models/segformer.py``) as the perceiver's segmenter
     at 1280x736 bf16, with the plain reference's seeded random weights
     (``perfbench/reference/segformer.py``: ``random_state``, the
     classifier fitted to two sim frames' masks): ``_raw_pipeline`` (the
     JPEG round trip, SegFormer and the extraction in one graph) against
     eager on 8 sim frames, every output and the logits bit-equal; the
     logits at stage 1's grid against the plain reference (float32, TF32
     off) on each frame's round trip within the benchmark cell's limit,
     and its float8 control outside it; each attention backend of
     ``F.scaled_dot_product_attention`` timed on the card's stream (a
     captured graph of calls) at the four stages' shapes, and the whole
     captured pipeline with each pinned in turn; ``perceive`` a frame, the segmenter
     alone, captured against eager; a profile of captured frames: the
     kernels a frame by device time, the attention's kernels and their
     share of its least time; with the monitor on, the SegFormer spans
     under ``perceiver.segment`` and a ``segmenter.forward:segformer_b2``
     count a frame. The kernels line gains the attention's row (route
     ``library``).
  19. Mask2Former-R50 (``models/mask2former.py``) as the perceiver's
     segmenter at 1280x736 bf16, with the plain reference's seeded
     random weights (``perfbench/reference/mask2former.py``:
     ``random_state``, the heads set from two sim frames, ``fit_heads``):
     ``csrc/ms_deform_attn.cu`` against its plain version at the
     published shapes (19,320 queries, 3 levels, 4 points), timed beside
     the plain version, the grid_sample composition and its bound;
     ``_raw_pipeline`` against eager on 6 sim frames, every output and
     the class logits, mask logits, encoder output and attention masks
     bit-equal, and six kernel launches a frame; the class, mask and
     encoder gaps against the plain reference (float32, TF32 off, fed
     the program's attention masks) within the benchmark cell's limits,
     and its float8 control outside one; each backend of
     ``F.scaled_dot_product_attention`` timed at the masked
     cross-attention's three key lengths; ``perceive`` a frame, the
     captured pipeline, the segmenter eager; a profile: the kernels a
     frame, the sampling kernel's time and its roofline share; with the
     monitor on, the Mask2Former spans under ``perceiver.segment`` and a
     ``segmenter.forward:mask2former_r50`` count a frame. The kernels
     line gains the ``ms_deform_attn`` row.
  20. SegFormer's head resample (``csrc/segformer_resample.cu``): the
     kernel against its plain version (``F.interpolate`` and
     ``torch.cat``) at 1280x736 and 640x384, N = 1 and 2, bf16 and
     float32: the share of bit-equal elements and the largest distance in
     ulps (one the most allowed), the strides; its ms at 1280x736 bf16 at
     each pixels-a-warp beside the plain version's and its bound; the
     SegFormer perceiver (seeded random weights) on 4 sim frames: the
     captured replays and the perceiver with the plain head against eager,
     logits, masks and tracks bit-equal, one launch a frame; a profile of
     captured frames: the resample's ms a frame and the kernels a frame.
     The kernels line gains the ``segformer_resample`` row.
  21. Mask2Former-Swin-L (``models/swin.py``, ``models/mask2former.py``)
     as the perceiver's segmenter at 1280x736 bf16, with the plain
     reference's seeded random weights (``perfbench/reference/swin.py``:
     ``random_state``, ``fit_heads`` on two sim frames):
     ``csrc/window_attention.cu`` against its plain version at Swin-L's
     four stage shapes, unshifted and shifted, each timed alone beside
     its bound, the plain version and the library's yardstick (SDPA on
     partitioned windows with a precomputed float bias and mask, timed
     here only); ``_raw_pipeline`` against eager on 4 sim frames, every
     output bit-equal, 24 window-attention and 6 deformable launches a
     frame; the class, mask, encoder and backbone gaps against the plain
     reference (fed the program's attention masks) within the benchmark
     cell's limits, and the float8 control outside one; ``perceive`` a
     frame and the captured pipeline; a profile: the kernels a frame,
     the window attention's time and its roofline share; with the
     monitor on, the Swin spans under ``mask2former.backbone``. The
     kernels line gains the ``window_attention`` row.
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
# perception (phase 10): sim poses of the chain-edges check, frames of
# the chained per-frame timing, of the loop (bench.py's short form) and
# of its profile
CHAIN_POSES = 16
PERCEPTION_FRAMES = 30
LOOP_FRAMES = 40
PROFILE_FRAMES = 10
# the JPEG round trip (phase 10): round trips a timed graph holds, its
# replays, and the simulator frames through ``Perceiver.perceive`` on
# each path
JPEG_PER_GRAPH, JPEG_REPS, PERCEIVE_FRAMES = 20, 50, 20
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
# phase 13: the raceline's JAX fixture and the
# tolerances of tests/test_torch_raceline.py (the QPs' stopping rule pins
# the curvature profile, not alpha: each point's curvature within a tenth
# of the largest of JAX's line, the summed squared curvature within 5e-3,
# alpha within the 1 m margin, the bound as JAX's plus 1e-3); the card
# against the CPU for the
# Pacejka model (fp32 transcendentals and 40 Euler steps); the dashboard
# run's frames; the localisation CLI's recording (the fewest control
# steps of the committed ones)
RACELINE_FIXTURE = ROOT / "tests" / "fixtures" / "torch_raceline_jax.npz"
RACELINE_MARGIN = 1.0
RACELINE_ALPHA_TOL, RACELINE_KAPPA_SHARE = RACELINE_MARGIN, 0.1
RACELINE_CURVATURE_RTOL, RACELINE_VIOLATION_SLACK = 5e-3, 1e-3
PACEJKA_TOL = 1e-4
DASHBOARD_FRAMES = 60
LOC_CLI_RECORDING = "vallelunga_synth"
# phase 14: ranks that share the card, the sharded exact profile's
# bound against the unsharded one on a real map (tests/test_torch_parallel.py:
# braking chains that cross a block edge are summed block by block), the
# closed loop's tolerance (tests/test_torch_lap_sweep.py's LOOP_TOL), the
# ADMM profile's (tests/test_horizon_sharded.py) and the launch CLI's
# full-lap steps
PARALLEL_RANKS = 2
REAL_MAP_ULPS = 2
LOOP_TOL = dict(rtol=5e-3, atol=5e-2)
ADMM_TOL = dict(rtol=1e-3, atol=2e-3)
CLI_LAP_STEPS = 300
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
# phase 15: lanes of the vmapped step held against get_control alone
# (picked by stride): the same iterations to the same status, commands
# within CPU_AGREE_TOL, since the two differ as the card and the CPU do,
# in the fp32 rounding of the KKT inverse (cuSOLVER's batched Cholesky
# against its single one, cuBLAS's batched products) and of the kernel's
# reductions (5 CTAs a scenario at B = 256, 8 at B = 1); 2.3e-4 on an H100
# (racing) and 1.4e-3 (mapping), the same every run. The fused engine's
# and the CPU's tolerance (the golden fixture's); the random QPs' batch
# and their tolerance against single solves (tests/test_torch_admm.py's
# X_TOL for converged solves whose arithmetic differs in rounding)
VMAP_LANES = 8
VMAP_LANE_TOL = CPU_AGREE_TOL
VMAP_TOL = 5e-3
VMAP_QPS = 64
VMAP_QP_TOL = 2e-2

# phase 16: the segmenter's trainer at the JAX tool's defaults. The card's
# step against the CPU's at the tool's frame size (batch 2), held with
# bench/train_step.py's tolerances and its gradient tolerance for the two
# devices; the trained checkpoint's sim frames at 1280x736 (the IoU gate
# is IOU_MIN, the shipped model's); steps timed with a synchronise, and
# steps profiled, after the training; XLA's cost analysis of the JAX
# step at the tool's shape (CPU, with its elementwise work), beside
# FlopCounterMode's count of the port's on the card
TRAIN_CHECK_BATCH = 2
TRAIN_IOU_FRAMES = 8
TRAIN_SYNCED_STEPS = 10
TRAIN_PROFILE_STEPS = 20
XLA_STEP_FLOP = 377.3e9
SHIPPED_FPN = ROOT / "data" / "models" / "segmentation" / "synthetic_fpn.msgpack"
# phase 17: closed-loop steps of each compiled control step against eager,
# frames of the perceiver's graph against eager, and steps (frames) a
# timed block (two blocks each, in turns)
COMPILED_STEPS = 200
COMPILED_FRAMES = 8
COMPILED_TIMED = 250
SEGFORMER_FRAMES = 8
SEGFORMER_SEED = 2**31 + 2020
SEGFORMER_TIMED = 50
MASK2FORMER_FRAMES = 6
MASK2FORMER_SEED = 2**31 + 2024
MASK2FORMER_TIMED = 50
SWIN_FRAMES = 4
SWIN_SEED = 2**31 + 2026
SWIN_TIMED = 30
# Swin-L's four stages at 1280x736: (grid, channels, heads, blocks)
SWIN_L_STAGES = (((184, 320), 192, 6, 2), ((92, 160), 384, 12, 2), ((46, 80), 768, 24, 18), ((23, 40), 1536, 48, 2))
RESAMPLE_FRAMES = ((736, 1280), (384, 640))
RESAMPLE_PERCEIVER_FRAMES = 4
# the kernel against its plain version: the same float32 locations,
# weights and taps summed in another order, each bf16 output within one
# rounding of the larger of the two, or float32 sums' rounding where the
# taps cancel near zero (tests/test_torch_cuda.py)
DEFORM_RTOL = 2.0 ** -7
DEFORM_ATOL_SHARE = 1e-5
# a trip of the loop kernel reads the flag (1 byte) and the trip count (8)
# and writes the count (8)
LOOP_TRIP_BYTES = 17


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


def chunk_bound(
    n: int, m: int, n_iters: int, n_active: int, batch: int, masked: bool, n_b: int = 0
):
    """Least time of one chunk call on an H100: each input read once and
    each output written once, against the flops of the active scenarios'
    iterations. With the box block (n_b = n of the m rows) what these
    inputs need: W_s (n, n + m_d), A_d (m_d, n) and g in place of the
    dense W and A, and the block's products by g. Returns (ms, "bytes" |
    "operations")."""
    m_d = m - n_b
    # W, A[, g], c0, rho, l, u
    operator = 4 * (n * (n + m_d) + m_d * n + (n if n_b else 0) + n + 3 * m)
    iterates = 4 * (n + 2 * m)  # x, z, y
    n_bytes = n_active * operator + 2 * batch * iterates + (batch if masked else 0)
    per_iter = 2 * n * (n + m_d) + 2 * m_d * n + 12 * m + 4 * n + (4 * n if n_b else 0)
    flops = n_active * n_iters * per_iter
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def ruiz_bound_ms(n: int, m: int, batch: int) -> float:
    """Least time of Ruiz scaling on an H100: P and A read once and P_s
    and A_s written once (and the vectors)."""
    n_bytes = 4 * batch * (2 * (n * n + m * n) + 4 * n + m + 1)
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def rel_err(got, want) -> float:
    """Largest |got - want| / |want| over a tuple of outputs; inf where a
    zero or a non-finite value differs."""
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        if not bool(torch.equal(torch.isfinite(g), torch.isfinite(w))):
            return float("inf")
        diff = (g - w).abs()
        zero = w == 0
        if bool((diff[zero] != 0).any()):
            return float("inf")
        if bool((~zero).any()):
            worst = max(worst, float((diff[~zero] / w[~zero].abs()).max()))
    return worst


def random_box_qps(batch: int, n: int, m: int, seed: int, device):
    """B random well-posed box QPs (P, q, A, l, u) at the true shapes:
    P = M M'/n + I/2, A (m, n) with every 17th row an equality; and the
    generator, for more draws."""
    import torch

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
    return (P, q, A, centre - half, centre + half), g


def random_chunk_inputs(batch: int, n: int, m: int, seed: int, device):
    """Chunk inputs at the true shapes from ``random_box_qps``: their
    ADMM operator at rho 0.1 (1e2 on equalities), so the iterates stay
    bounded as in a real solve."""
    import torch

    from acmpc_tpu_torch.qp.admm import _build_operator, _factor, _rho_vector

    (P, q, A, lo, hi), g = random_box_qps(batch, n, m, seed, device)
    rho = _rho_vector(torch.tensor(0.1, device=device), lo, hi)
    W, c0 = _build_operator(_factor(P, A, rho, 1e-5), A, q, 1e-5)
    x = 0.1 * torch.randn(batch, n, generator=g, device=device)
    z = torch.clamp((A @ x[..., None])[..., 0], lo, hi)
    y = 0.1 * torch.randn(batch, m, generator=g, device=device)
    return W, A.contiguous(), c0, rho, lo, hi, x, z, y


def box_chunk_inputs(P, q, A, l, u, sigma: float = 1e-5):
    """The chunk inputs of B QPs whose A is [A_d; I], as the solver makes
    them (bounds clamped, Ruiz scaling, rho 0.1 by constraint class, the
    KKT inverse), from a cold start (x = 0, y = 0): (the dense operator's
    inputs, the box block's, its keywords g and sigma)."""
    import torch

    from acmpc_tpu_torch.qp.admm import (
        _INF,
        _box_block,
        _build_operator,
        _factor,
        _rho_vector,
        _ruiz_equilibrate,
    )

    Ps, qs, As, _, _, e = _ruiz_equilibrate(P, q, A, 10)
    ls, us = e * torch.clamp(l, -_INF, _INF), e * torch.clamp(u, -_INF, _INF)
    rho = _rho_vector(torch.tensor(0.1, device=q.device), ls, us)
    K_inv = _factor(Ps, As, rho, sigma)
    W, c0 = _build_operator(K_inv, As, qs, sigma)
    As_d, g = _box_block(As, True)
    W_s, _ = _build_operator(K_inv, As, qs, sigma, As_d)
    x = torch.zeros_like(qs)
    z = torch.clamp((As @ x[..., None])[..., 0], ls, us)
    y = torch.zeros_like(ls)
    vectors = (c0, rho, ls, us, x, z, y)
    return (W, As, *vectors), (W_s, As_d.contiguous(), *vectors), {"g": g, "sigma": sigma}


def box_qps(n: int, m: int, batch: int):
    """The main path's QPs at (n, m), (P, q, A, l, u) on the card: monza's
    racing control (horizon 50) on ``batch`` windows of the difficulty
    ramp by stride, or its mapping control (horizon 100) on the gentlest;
    for n = m, monza's raceline QP at its first re-linearisation (586
    points at the raceline CLI's cap, 1,953 at stride 6; B = 1)."""
    import torch

    if n == m:
        from acmpc_tpu_torch.utils.raceline import _unit_normals, raceline_qp

        key = {586: "monza/cap", 1953: "monza/stride6"}[n]
        centre, half = _raceline_case(key, np.load(RACELINE_FIXTURE))
        centre = torch.tensor(centre, dtype=torch.float32, device=DEVICE)
        bound = torch.clamp(torch.tensor(half, dtype=torch.float32, device=DEVICE) - RACELINE_MARGIN, min=0.0)
        qp = raceline_qp(centre, _unit_normals(centre), bound, torch.zeros(n, device=DEVICE))
        return tuple(t.expand(batch, *t.shape) for t in qp)
    mode = "racing" if (n, m) == H50 else "mapping"
    mpc = make_mpc("monza", DEVICE, mode=mode)
    ramp = difficulty_ramp(mpc.config.horizon, BATCH)
    refs = torch.as_tensor(ramp[:: BATCH // batch][:batch] if mode == "racing" else ramp[:batch], device=DEVICE)
    full = lambda v, dtype=torch.float32: torch.full((batch,), v, dtype=dtype, device=DEVICE)  # noqa: E731
    _, _, qp = mpc._prepare(
        mpc.initial_state(batch), refs, full(mpc.config.constraints.v_max), full(False, torch.bool), full(0.0)
    )
    if tuple(qp[2].shape) != (batch, m, n):
        raise RuntimeError(f"the {mode} QP is {tuple(qp[2].shape)}, not ({batch}, {m}, {n})")
    return qp


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
    # the compiled entries' WHILE nodes need CUDA 12.4 in PyTorch's build
    # and in the driver
    import ctypes

    driver = ctypes.c_int(0)
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(driver))
    info["driver_cuda"] = driver.value
    built = tuple(int(v) for v in torch.version.cuda.split(".")[:2])
    if built < (12, 4) or driver.value < 12040:
        raise RuntimeError(f"CUDA 12.4 or later needed: PyTorch built for {torch.version.cuda}, driver {driver.value}")
    emit("phase 1 device", info)
    return info


def phase_build() -> dict:
    import concurrent.futures

    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops
    import acmpc_tpu_torch.ops.graph_loop as graph_loop
    import acmpc_tpu_torch.ops.ruiz as ruiz
    import acmpc_tpu_torch.ops.track_chain as chain
    from acmpc_tpu_torch.ops.cuda_build import BUILD_DIR

    dev = torch.cuda.current_device()
    t0 = time.perf_counter()
    # every source compiles at once: the chunk kernels' two, the chain
    # edges', the graph loop's, the Ruiz kernel's
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [
            pool.submit(f, dev)
            for f in (ops._libraries, chain._edges_library, graph_loop._library, ruiz._library)
        ]
        for done in builds:
            done.result()
    info = {
        "sources": sorted([*ops.SOURCES.values(), chain.EDGES_SOURCE, graph_loop.SOURCE, ruiz.SOURCE]),
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


def _cluster_layouts(dev, n: int, m: int, n_b: int) -> dict:
    """Every cluster size at (n, m) with n_b box rows: the wrapper's layout
    held against the library's, and for every size that fits, its shared
    bytes per CTA and how many such clusters the card holds at once."""
    import acmpc_tpu_torch.ops.admm_chunk as ops

    lib = ops._libraries(dev)["cluster"]
    out = {}
    for C in range(1, ops.MAX_CLUSTER + 1):
        smem = ops.cluster_smem_bytes(n, m, C, n_b)
        if lib.admm_chunk_cluster_smem_bytes(n, m, C, int(bool(n_b))) != smem:
            raise RuntimeError(f"n={n}, m={m}, n_b={n_b}, C={C}: the wrapper's cluster layout is not the kernel's")
        if smem <= ops.SMEM_PER_BLOCK:
            plan = ops.cluster_plan(n, m, C, n_b)
            out[C] = {"smem_bytes": smem, "max_active_clusters": ops.max_active_clusters(plan, n, m, dev)}
    return out


def _split_layout_facts(dev, n: int, m: int, C: int, n_b: int = 0) -> dict:
    """The split plan's layout at C CTAs held against the library's; for a
    layout that fits, its resident rows, the bytes a CTA streams an
    iteration and how many such clusters the card holds at once."""
    import ctypes

    import acmpc_tpu_torch.ops.admm_chunk as ops

    lib = ops._libraries(dev)["split"]
    plan = ops.split_plan(n, m, C, n_b=n_b)
    lay = ops.split_layout(n, m, C, n_b=n_b)
    box = int(bool(n_b))
    res_w, res_a = ctypes.c_int(), ctypes.c_int()
    lib.admm_chunk_split_resident_rows(
        n, m, C, plan.stages, plan.stage_bytes, box, ctypes.byref(res_w), ctypes.byref(res_a)
    )
    lib_bytes = lib.admm_chunk_split_smem_bytes(n, m, C, plan.stages, plan.stage_bytes, box)
    if (lib_bytes, res_w.value, res_a.value) != (lay.bytes, lay.res_w, lay.res_a):
        raise RuntimeError(f"n={n}, m={m}, n_b={n_b}, C={C}: the wrapper's split layout is not the kernel's")
    if lay.bytes > ops.SMEM_PER_BLOCK:
        return {}
    k_w = n + m - n_b
    return {
        "smem_bytes": lay.bytes,
        "stage_floats": lay.stage_floats,
        "resident_rows_w_a": [lay.res_w, lay.res_a],
        "rows_w_a": [lay.rows_w, lay.rows_a],
        "streamed_bytes_per_cta_iter": 4 * ((lay.rows_w - lay.res_w) * k_w + (lay.rows_a - lay.res_a) * n),
        "max_active_clusters": ops.max_active_clusters(plan, n, m, dev),
    }


def _layouts(dev) -> dict:
    """Every cluster size at horizon 50 (cluster kernel) and horizon 100
    (split kernel) on the dense operator, and on the box block at horizon
    50, horizon 100 and the 586-point raceline (cluster kernel) and the
    1,953-point raceline (split kernel): the wrapper's layouts against
    the library's, and the sizes that fit with their shared bytes and
    clusters held at once."""
    out = {"clusters_h50": _cluster_layouts(dev, *H50, 0), "splits_h100": {}}
    for C in range(1, 17):
        facts = _split_layout_facts(dev, *H100, C)
        if facts:
            out["splits_h100"][C] = facts
    for (n, m), key in ((H50, "box_clusters_h50"), (H100, "box_clusters_h100"), ((586, 586), "box_clusters_n586")):
        out[key] = _cluster_layouts(dev, n, m, n)
    out["box_splits_n1953"] = {C: _split_layout_facts(dev, 1953, 1953, C, 1953) for C in (8, 12, 16)}
    return out


def phase_kernel() -> dict:
    """Every kernel variant against its plain version on the card, with
    times, and the cluster-size sweeps."""
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
                    if not masked:
                        row["ms_by_C"] = {}
                        for p in sweep[(n, m), batch]:
                            compare(run(p), want, f"{key} C={p.cluster}")
                            row["ms_by_C"][p.cluster] = time_cuda_ms(lambda: run(p), reps=20)
                results[key] = row
    results.update(_box_chunks())
    results["ruiz"] = _ruiz_kernel(dev)
    emit("phase 3 kernel vs plain", {"n_iters": N_ITERS, **results})
    return results


# the Ruiz kernel in phase 3: the main path's shapes and batches at the
# MPC's passes (every controller's scaling_iters), and the 1,953-point
# raceline (the streamed plan) at the raceline's 10, held to the plain
# version: products, square roots and maxima round alike, the mean over n
# sums in another order and divides where PyTorch's CUDA mean multiplies
# by a rounded 1/n (tests/test_torch_cuda.py's RUIZ_RTOL)
RUIZ_SHAPES = ((H50, 1, 5), (H50, BATCH, 5), (H100, 1, 5), ((1953, 1953), 1, 10))
RUIZ_RTOL = 1e-5


def _ruiz_kernel(dev) -> dict:
    """The Ruiz kernel (``ops/ruiz.py``) on the main path's QPs
    (``box_qps``) at horizon 50 (B 1, 256) and horizon 100 (B 1), and on
    the 1,953-point raceline's first QP (B 1, streamed): one launch of the
    planned kernel a call, its largest relative difference from the plain
    version, ms, the plain version's ms and the bound (P and A read once,
    P_s and A_s written once); the wrapper's layout against the library's
    at every cluster size of both plans at these shapes and the 586-point
    raceline's."""
    import torch

    import acmpc_tpu_torch.ops.ruiz as ruiz

    lib = ruiz._library(dev)
    for n, m in (H50, H100, (586, 586), (1953, 1953)):
        for C in range(1, ruiz.MAX_CLUSTER + 1):
            for resident in (True, False):
                if lib.ruiz_equilibrate_smem_bytes(n, m, C, int(resident)) != ruiz.smem_bytes(n, m, C, resident):
                    raise RuntimeError(f"n={n}, m={m}, C={C}: the wrapper's Ruiz layout is not the kernel's")
    out = {}
    for (n, m), batch, passes in RUIZ_SHAPES:
        P, q, A, _, _ = (t.contiguous() for t in box_qps(n, m, batch))
        plan = ruiz.plan_ruiz(n, m, batch)
        name = ruiz.kernel_name(plan)
        want = ruiz.ruiz_equilibrate_reference(P, q, A, passes)
        ruiz.ruiz_equilibrate.launches.clear()
        got = ruiz.ruiz_equilibrate(P, q, A, passes)
        torch.cuda.synchronize()
        if dict(ruiz.ruiz_equilibrate.launches) != {name: 1}:
            raise RuntimeError(f"Ruiz n={n} B={batch}: expected one launch of {name}, got {dict(ruiz.ruiz_equilibrate.launches)}")
        err = rel_err(got, want)
        if not err <= RUIZ_RTOL:
            raise RuntimeError(f"Ruiz n={n} B={batch}: the kernel is {err} from the plain version (> {RUIZ_RTOL})")
        out[f"n{n}_B{batch}"] = {
            "kernel": name,
            "C": plan.cluster,
            "passes": passes,
            "max_rel_err": err,
            "ms": time_cuda_ms(lambda: ruiz.ruiz_equilibrate(P, q, A, passes), reps=20),
            "plain_ms": time_cuda_ms(lambda: ruiz.ruiz_equilibrate_reference(P, q, A, passes), reps=5),
            "bound_ms": ruiz_bound_ms(n, m, batch),
            "bound_by": "bytes",
        }
    if out["n1953_B1"]["kernel"] != ruiz.STREAMED:
        raise RuntimeError(f"the 1,953-point raceline took {out['n1953_B1']['kernel']}, not {ruiz.STREAMED}")
    return out


# the box block's shapes and batches in phase 3, and the cluster sizes
# timed beside each plan (the B <= 15 rule of plan_chunk at horizon 50,
# the sizes above the fewest at horizon 100 and 586 points)
BOX_CHUNKS = ((H50, (1, 7, BATCH)), (H100, (1, MAPPING_BATCH)), ((586, 586), (1,)), ((1953, 1953), (1,)))
BOX_SWEEP = {
    (H50, 1): (3, 4, 6, 8, 12, 16),
    (H50, 7): (3, 4, 8),
    (H50, BATCH): (3, 4, 5, 8),
    (H100, 1): (10, 12, 16),
    (H100, MAPPING_BATCH): (10, 12, 16),
    ((586, 586), 1): (7, 8, 12, 16),
}


def _box_chunks() -> dict:
    """Each box-block variant as planned against both plain versions (the
    box block's, and the dense one on the dense operator of the same QP)
    on the main path's QPs (``box_qps``, from a cold start) at horizon 50
    (B 1, 7, 256), horizon 100 (B 1, 8) and the raceline's 586 and 1,953
    points, with and without a mixed ``active`` mask: its
    ms, the plain version's, both bounds (the dense operator's, and what
    these inputs need), the operator's bytes either way; the dense
    kernel as planned on the dense operator of the same QP (the earlier
    figure); and unmasked, the other cluster sizes."""
    import torch

    import acmpc_tpu_torch.ops.admm_chunk as ops

    out = {}
    for (n, m), batches in BOX_CHUNKS:
        m_d = m - n
        for batch in batches:
            dense, box, kw = box_chunk_inputs(*box_qps(n, m, batch))
            plan, dense_plan = ops.plan_chunk(n, m, batch, n), ops.plan_chunk(n, m, batch)
            active = torch.arange(batch, device=DEVICE) % 3 != 1
            for masked in (False, True):
                mask = active if masked else None
                key = f"box_n{n}_B{batch}{'_active' if masked else ''}"

                def run(p=plan, mask=mask):
                    return ops._launch(p, *box, n_iters=N_ITERS, alpha=ALPHA, active=mask, **kw)

                def run_dense(mask=mask):
                    return ops._launch(dense_plan, *dense, n_iters=N_ITERS, alpha=ALPHA, active=mask)

                def plain(mask=mask):
                    return ops.admm_chunk_box_reference(*box, n_iters=N_ITERS, alpha=ALPHA, active=mask, **kw)

                want = plain()
                want_dense = ops.admm_chunk_reference(*dense, n_iters=N_ITERS, alpha=ALPHA, active=mask)
                ops.admm_chunk.launches.clear()
                got = ops.admm_chunk(*box, n_iters=N_ITERS, alpha=ALPHA, active=mask, **kw)
                name = ops.kernel_name(plan, masked)
                if dict(ops.admm_chunk.launches) != {name: 1}:
                    raise RuntimeError(f"{key}: expected one launch of {name}, got {dict(ops.admm_chunk.launches)}")
                n_active = int(active.sum()) if masked else batch
                row = {
                    "kernel": name,
                    "C": plan.cluster,
                    "max_abs_err": compare(got, want, key),
                    "dense_plain_max_abs_err": compare(got, want_dense, f"{key} vs the dense plain version"),
                    "ms": time_cuda_ms(run, reps=20),
                    "plain_ms": time_cuda_ms(plain, reps=5),
                    "operator_bytes": 4 * (n * (n + m_d) + m_d * n + n),
                    "dense_operator_bytes": 4 * (n * (n + m) + m * n),
                    "dense_kernel": ops.kernel_name(dense_plan, masked),
                    "dense_C": dense_plan.cluster,
                    "dense_max_abs_err": compare(run_dense(), want_dense, f"{key} dense"),
                    "dense_ms": time_cuda_ms(run_dense, reps=20),
                }
                row["bound_ms"], row["bound_by"] = chunk_bound(n, m, N_ITERS, n_active, batch, masked, n)
                row["dense_bound_ms"], row["dense_bound_by"] = chunk_bound(n, m, N_ITERS, n_active, batch, masked)
                if plan.variant == "split":
                    row.update(_split_layout_facts(torch.cuda.current_device(), n, m, plan.cluster, n))
                sweep = BOX_SWEEP.get(((n, m), batch), ())
                if sweep and not masked:
                    row["ms_by_C"] = {}
                    for C in sweep:
                        p = ops.cluster_plan(n, m, C, n)
                        compare(run(p), want, f"{key} C={C}")
                        row["ms_by_C"][C] = time_cuda_ms(lambda: run(p), reps=20)
                out[key] = row
    return out


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

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, CLUSTER_BOX_ACTIVE, admm_chunk

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
    for name in (CLUSTER_BOX, CLUSTER_BOX_ACTIVE):
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
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, admm_chunk

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
    golden_launches = admm_chunk.launches[CLUSTER_BOX]
    if golden_launches == 0:
        raise RuntimeError(f"get_control never launched {CLUSTER_BOX}")

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
    """Monza's mapping control (horizon 100), whose operator a cluster of
    10 holds on the box block: a cold step with skipping on, then five
    warm steps, at B = 8."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, CLUSTER_BOX_ACTIVE, admm_chunk

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
    for name in (CLUSTER_BOX, CLUSTER_BOX_ACTIVE):
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

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, admm_chunk

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
    if launches.get(CLUSTER_BOX, 0) == 0:
        raise RuntimeError(f"mapping get_control never launched {CLUSTER_BOX}")

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
    from acmpc_tpu_torch.ops import graph_loop
    from acmpc_tpu_torch.ops.admm_chunk import admm_chunk
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate
    from acmpc_tpu_torch.ops.track_chain import chain_edges

    counters = (
        admm_chunk.launches, chain_edges.launches, graph_loop.device_while.launches,
        jpeg_round_trip.launches, ruiz_equilibrate.launches,
    )
    graph_loop.settle_launches()  # the replays' loop bodies, before the clear
    for counter in counters:
        counter.clear()
    out = fn()
    graph_loop.settle_launches()
    counts = {name: n for counter in counters for name, n in counter.items()}
    return out, {name: n for name, n in counts.items() if n}


def _sub_grid(grid, n: int):
    """The first ``n`` scenarios of a sweep grid."""
    return type(grid)(*(getattr(grid, f.name)[:n] for f in dataclasses.fields(grid)))


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def _per_step(n_steps: int) -> dict:
    """The launches of ``n_steps`` closed-loop steps as ``_counted`` counts
    them: one cluster chunk (one RTI chunk a solve) and one Ruiz scaling
    a step."""
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX
    from acmpc_tpu_torch.ops.ruiz import RESIDENT

    return {CLUSTER_BOX: n_steps, RESIDENT: n_steps}


def _check_closed_loop(label: str, want: dict, launches: dict, rate: float, least: float):
    """The closed loop's launches are ``want`` and its solve success is at
    least ``least``."""
    if launches != want:
        raise RuntimeError(f"{label}: expected launches {want}, got {launches}")
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
    _check_closed_loop("sweep", _per_step(SWEEP_STEPS), sweep_launches, summary["solve_success_rate"], 0.99)
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
    rsweep.run_fused(rgrid, 1)  # untimed: the step's graph at this batch
    raceline, raceline_launches = _counted(lambda: run_laps(rsweep, rgrid, dt, RACELINE_STEPS))
    if raceline["total_solves"] != RACELINE_BATCH * RACELINE_STEPS:
        raise RuntimeError(f"raceline: {raceline['total_solves']} solves")
    _check_closed_loop("raceline", _per_step(RACELINE_STEPS), raceline_launches, raceline["solve_success_rate"], 0.9)

    # the full-lap tool's loop at B = 32
    sweep.run_fused(grid_of(LAP_BATCH), 1)  # untimed: the step's graph at this batch
    laps, lap_launches = _counted(lambda: run_laps(sweep, grid_of(LAP_BATCH), dt, LAP_STEPS))
    if laps["sequential_solves_per_scenario"] != LAP_STEPS:
        raise RuntimeError(f"full lap: {laps['sequential_solves_per_scenario']} sequential solves")
    _check_closed_loop("full lap", _per_step(LAP_STEPS), lap_launches, laps["solve_success_rate"], 0.99)

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
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX
    from acmpc_tpu_torch.ops.ruiz import RESIDENT

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
    # the box-block cluster kernel only, and the Ruiz kernel once a batched
    # solve (the fixture's one; the grid's cold and five warm steps)
    for label, counts, solves in (("fixture", fixture_launches, 1), ("grid", grid_launches, 6)):
        if counts.get(CLUSTER_BOX, 0) == 0 or set(counts) != {CLUSTER_BOX, RESIDENT} or counts[RESIDENT] != solves:
            raise RuntimeError(
                f"multi-track {label}: expected launches of {CLUSTER_BOX} and {solves} of {RESIDENT}, got {counts}"
            )
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


def _flat_leaves(tree: dict) -> list:
    """The arrays of a nested dict."""
    leaves, stack = [], [tree]
    while stack:
        for v in stack.pop().values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                leaves.append(v)
    return leaves


def _iou(pred: np.ndarray, truth: np.ndarray) -> float:
    pred, truth = pred == 1, truth.astype(bool)
    return float((pred & truth).sum() / max((pred | truth).sum(), 1))


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


def _jpeg_round_trip(perc, frames: dict) -> dict:
    """The JPEG round-trip kernels at the camera's size on each host frame
    of ``frames``: byte-equal to the plain version on the card and to the
    perceiver's host round trip (OpenCV); each kernel's us a launch
    (``torch.profiler``), the pair's us a round trip in a graph of
    ``JPEG_PER_GRAPH`` (launched as the perception graph launches them),
    the plain version's and OpenCV's ms. The bound: the frame read once
    (the blocks kernel) and written once (the colour kernel)."""
    import torch

    from acmpc_tpu_torch.bench.step_breakdown import device_time
    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt

    rows = {}
    for name, frame in frames.items():
        image = torch.as_tensor(frame, device=DEVICE)
        got = jrt.jpeg_round_trip(image)
        if not torch.equal(got, jrt.jpeg_round_trip_reference(image)):
            raise RuntimeError(f"JPEG round trip {name}: the kernels differ from the plain version")
        t0 = time.perf_counter()
        opencv = [perc._encode_decode_image(frame) for _ in range(JPEG_PER_GRAPH)][-1]
        opencv_ms = 1e3 * (time.perf_counter() - t0) / JPEG_PER_GRAPH
        if not np.array_equal(got.cpu().numpy(), opencv):
            raise RuntimeError(f"JPEG round trip {name}: the kernels differ from OpenCV's round trip")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [jrt.jpeg_round_trip(image) for _ in range(JPEG_PER_GRAPH)]
        pair_ms = time_cuda_ms(graph.replay, JPEG_REPS) / JPEG_PER_GRAPH
        del outs, graph
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(JPEG_REPS):
                jrt.jpeg_round_trip(image)
            torch.cuda.synchronize()
        _, per_kernel = device_time(prof)
        kernel_ms = {
            kernel: 1e-3 * sum(us for key, (us, _) in per_kernel.items() if kernel in key) / JPEG_REPS
            for kernel in (jrt.BLOCKS_KERNEL, jrt.COLOUR_KERNEL)
        }
        rows[name] = {
            "bit_equal_plain": True,
            "bit_equal_opencv": True,
            "pair_ms": pair_ms,
            **{f"{kernel}_ms": ms for kernel, ms in kernel_ms.items()},
            "plain_ms": time_cuda_ms(lambda: jrt.jpeg_round_trip_reference(image), reps=5),
            "opencv_ms": opencv_ms,
        }
    h, w = next(iter(frames.values())).shape[:2]
    frame_ms = 1e3 * 3 * h * w / HBM_BYTES_PER_S
    return {"resolution": f"{w}x{h}", "bound_ms": 2 * frame_ms, "kernel_bound_ms": frame_ms, **rows}


def _perceive_paths(perc, frames: list) -> dict:
    """``Perceiver.perceive`` on the card path against the host path
    (OpenCV's round trip, the upload, ``_pipeline``) on the same host
    frames: outputs bit-equal, a frame's launches (after a warm frame on
    each path) exact, and each path's ms a frame to a synchronise."""
    import torch

    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt
    from acmpc_tpu_torch.ops import track_chain as chain

    def host(frame):
        image = torch.as_tensor(perc._encode_decode_image(frame), device=DEVICE)
        drivable, _, tracks = perc._pipeline(image)
        return drivable, tracks["centre"]

    def card(frame):
        out = perc.perceive(frame)
        return out["drivable"], out["centreline"]

    walls = {"card": [], "host": []}
    for name, fn in (("card", card), ("host", host)):
        fn(frames[0])
        torch.cuda.synchronize()

        def run(fn=fn, name=name):
            outs = []
            for frame in frames:
                t0 = time.perf_counter()
                outs.append(fn(frame))
                torch.cuda.synchronize()
                walls[name].append(1e3 * (time.perf_counter() - t0))
            return outs

        walls[name + "_outs"], walls[name + "_launches"] = _counted(run)
    n = len(frames)
    want = {
        "card": {jrt.BLOCKS_KERNEL: n, jrt.COLOUR_KERNEL: n, chain.TRACK_CHAIN_EDGES: n},
        "host": {chain.TRACK_CHAIN_EDGES: n},
    }
    for name, counts in want.items():
        if walls[name + "_launches"] != counts:
            raise RuntimeError(f"perceive, {name} path: launches {walls[name + '_launches']}, expected {counts}")
    for i, (a, b) in enumerate(zip(walls["card_outs"], walls["host_outs"])):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"perceive: frame {i} differs between the card path and the host path")
    return {
        "frames": n,
        "bit_equal": True,
        "launches_card": walls["card_launches"],
        "launches_host": walls["host_launches"],
        "card_ms_p50": float(np.median(walls["card"])),
        "host_ms_p50": float(np.median(walls["host"])),
    }


def phase_perception() -> dict:
    """Perception on the card: checkpoint, IoU gate, chain-edges kernel
    against its plain version at 1280x736, the per-frame time, the JPEG
    round-trip kernels and ``perceive`` on each path, and the
    camera-to-command loop."""
    import torch

    from acmpc_tpu_torch.bench import chain_stages
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.bench.full_lap import closed_loop_mpc
    from acmpc_tpu_torch.localise.track_map import TrackMap
    from acmpc_tpu_torch.models.checkpoint import read_checkpoint
    from acmpc_tpu_torch.ops import track_chain as chain
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

    t_phase = time.perf_counter()
    info: dict = {}

    # 1. the shipped checkpoint through the port's reader
    cfg = loop.perception_config()  # 1280x736, bf16, training camera
    variables = read_checkpoint(ROOT / cfg.model_path)
    leaves = _flat_leaves(variables)
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

    # 3. the masks of the extraction's checks at 1280x736
    H, W = cfg.image_height, cfg.image_width
    centre, left, right, lap_m = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    cases = [(f"sim{k}", m, cfg.n_rows_to_remove_bonnet) for k, m in enumerate(loop.sim_masks(sim, centre, CHAIN_POSES))]
    adversarial, bonnet = loop.adversarial_masks(H, W)
    cases += [(name, m, bonnet) for name, m in adversarial.items()]

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
    # timed on sim0 in turns: fused kernel, the plain version, then back
    mask = torch.as_tensor(cases[0][1], device=DEVICE)
    bonnet_row = cases[0][2]
    edges_timing = {}
    for band in (4, 1):
        runs = {
            "ms": (lambda: chain._launch_edges(mask, bonnet_row, 3, band, False), 100),
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

    # 4b. the JPEG round-trip kernels on a simulator frame and a random
    # one; then the simulator's frames through perceive on each path
    host_frames, _ = loop.sim_frames(sim, centre, PERCEIVE_FRAMES)
    random_frame = np.random.default_rng(19).integers(0, 256, (H, W, 3), dtype=np.uint8)
    info["jpeg_round_trip"] = _jpeg_round_trip(perc, {"sim": host_frames[0], "random": random_frame})
    info["perceive"] = _perceive_paths(perc, host_frames)

    # 5. the camera-to-command loop
    mpc = closed_loop_mpc(DEVICE)
    run, launches = _counted(lambda: loop.perception_in_loop(perc, mpc, sim, centre, lap_m, LOOP_FRAMES))
    if run["solve_success"] != 1.0:
        raise RuntimeError(f"perception loop: solve success {run['solve_success']}")
    if not run["max_offtrack_m"] < loop.HALF_WIDTH:
        raise RuntimeError(f"perception loop: the car left the track by {run['max_offtrack_m']} m")
    # one fused extraction per frame, plus the untimed warm frame (replays
    # of the pipeline's graph, which the per-frame timing captured)
    warm = 1 + run["captured_warm_frame"]
    if launches.get(chain.TRACK_CHAIN_EDGES, 0) != run["frames"] + warm:
        raise RuntimeError(f"perception loop: chain launches {launches} for {run['frames']} + {warm} frames")
    # the loop feeds its frames to ``_pipeline`` as they are, as bench.py's
    # loop does: no JPEG round trip (4b counts perceive's)
    if any(name.startswith("jpeg_round_trip") for name in launches):
        raise RuntimeError(f"perception loop: JPEG round-trip launches {launches}")
    if launches.get(CLUSTER_BOX, 0) == 0:
        raise RuntimeError(f"perception loop never launched {CLUSTER_BOX}: {launches}")
    info["loop"] = run
    # the loop's launches and those of 4b's perceive, both paths
    info["launches"] = dict(
        collections.Counter(launches) + collections.Counter(info["perceive"]["launches_card"])
        + collections.Counter(info["perceive"]["launches_host"])
    )
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


def _curvature(centre: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """The signed curvature of centre + alpha * normal, in fp32 on the
    CPU."""
    import torch

    from acmpc_tpu_torch.utils.raceline import offset_curvature

    f32 = (torch.tensor(np.asarray(a, np.float32)) for a in (centre, alpha))
    return offset_curvature(*f32).numpy()


def _raceline_case(key: str, fixture) -> tuple:
    """The centreline and half widths of a fixture case (``<track>/cap``
    or ``<track>/stride<k>``), made as the raceline CLI makes them."""
    from acmpc_tpu_torch.cli import raceline as cli
    from acmpc_tpu_torch.localise.track_map import load_track_map

    track, how = key.split("/")
    tm = load_track_map(ROOT / "data" / "maps" / f"{track}.npz", device=DEVICE)
    centre_all, left = tm.centre.cpu().numpy(), tm.left.cpu().numpy()
    stride = cli.cap_stride(len(centre_all)) if how == "cap" else int(how.removeprefix("stride"))
    centre, half = cli.corridor(centre_all, left, stride)
    if not np.array_equal(centre.astype(np.float32), fixture[f"{key}/centre"]):
        raise RuntimeError(f"raceline {key}: the centreline is not the fixture's")
    return centre, half


def _racelines() -> dict:
    """Phase 13 (a): every fixture case on the card against JAX's alpha."""
    import torch

    from acmpc_tpu_torch.ops import ruiz
    from acmpc_tpu_torch.ops.admm_chunk import kernel_name, plan_chunk
    from acmpc_tpu_torch.utils.raceline import solve_raceline

    fixture = np.load(RACELINE_FIXTURE)
    keys = sorted({k.rsplit("/", 1)[0] for k in fixture.files})
    solve_raceline(*_raceline_case(keys[0], fixture), device=DEVICE)  # untimed: first use
    rows, launches = {}, collections.Counter()
    for key in keys:
        centre, half = _raceline_case(key, fixture)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve_raceline(centre, half, margin=RACELINE_MARGIN, device=DEVICE)
            alpha = r.alpha.cpu().numpy()
            return r, alpha, time.perf_counter() - t0

        (r, alpha, seconds), counts = _counted(run)
        want = fixture[f"{key}/alpha"]
        bound = np.maximum(half - RACELINE_MARGIN, 0.0)
        violation = max(0.0, float(np.max(np.abs(alpha) - bound)))
        jax_violation = max(0.0, float(np.max(np.abs(want) - bound)))
        err = float(np.abs(alpha - want).max())
        k, k_jax = _curvature(centre, alpha), _curvature(centre, want)
        k2, k2_jax = float((k**2).sum()), float((k_jax**2).sum())
        iterations = [int(sol.iterations) for sol in r.solutions]
        row = {
            "points": len(centre),
            "ms": 1e3 * seconds,
            "status": [int(sol.status) for sol in r.solutions],
            "iterations": iterations,
            "chunks_per_qp": [it // 25 for it in iterations],
            "launches": counts,
            "alpha_max_abs_err_m": err,
            "violation_m": violation,
            "jax_violation_m": jax_violation,
            "kappa_max_abs_err": float(np.abs(k - k_jax).max()),
            "kappa_max_abs_jax": float(np.abs(k_jax).max()),
            "squared_curvature": k2,
            "squared_curvature_rel_err": abs(k2 / k2_jax - 1.0),
        }
        if not all(bool(sol.solved) for sol in r.solutions) or not np.isfinite(alpha).all():
            raise RuntimeError(f"raceline {key}: a QP unsolved or alpha not finite: {row}")
        # the box block: a cluster up to 942 points, the split kernel at
        # 1,953; the Ruiz kernel once a QP (streamed at 1,953 points)
        n = len(centre)
        want_counts = {
            kernel_name(plan_chunk(n, n, 1, n), False): sum(iterations) // 25,
            ruiz.kernel_name(ruiz.plan_ruiz(n, n, 1)): len(r.solutions),
        }
        if counts != want_counts:
            raise RuntimeError(f"raceline {key}: expected launches {want_counts} only: {counts}")
        if (
            err > RACELINE_ALPHA_TOL
            or row["kappa_max_abs_err"] > RACELINE_KAPPA_SHARE * row["kappa_max_abs_jax"]
            or row["squared_curvature_rel_err"] > RACELINE_CURVATURE_RTOL
            or violation > jax_violation + RACELINE_VIOLATION_SLACK
        ):
            raise RuntimeError(f"raceline {key} disagrees with the JAX fixture: {row}")
        rows[key] = row
        launches.update(counts)
    return {"cases": rows, "launches": dict(launches)}


def _pacejka() -> dict:
    """Phase 13 (b): the Pacejka model on the card against the CPU."""
    from acmpc_tpu_torch.dynamics import pacejka

    out = {}
    for name in ("ACCELERATION_DATA", "BRAKING_DATA"):
        data = getattr(pacejka, name)
        card = pacejka.fit_long_force(data, device=DEVICE)
        cpu = pacejka.fit_long_force(data, device="cpu")
        err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        if not err <= PACEJKA_TOL:
            raise RuntimeError(f"fit_long_force({name}): card and CPU differ by {err} (relative)")
        out[f"fit_{name.lower()}_rel_err"] = err
    card, cpu = pacejka.DynamicBicycleModel(device=DEVICE), pacejka.DynamicBicycleModel(device="cpu")
    state = np.array([0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    for steer in (0.0, 0.1):
        controls = np.tile(np.array([steer, 1.0]), (40, 1))
        got = card.rollout(state, controls, dt=0.05).cpu().numpy()
        want = cpu.rollout(state, controls, dt=0.05).numpy()
        err = float(np.abs(got - want).max())
        if got.shape != (40, 6) or not np.allclose(got, want, rtol=PACEJKA_TOL, atol=PACEJKA_TOL):
            raise RuntimeError(f"rollout steer {steer}: card and CPU differ by {err}")
        # tests/test_tools.py's gates: throttle speeds the car up, straight
        # stays straight, steering curves the path
        if not got[-1, 3] > 10.5 or (abs(got[-1, 1]) < 1.0) != (steer == 0.0):
            raise RuntimeError(f"rollout steer {steer}: final state {got[-1]}")
        out[f"rollout_steer{steer}_max_abs_err"] = err
        out[f"rollout_steer{steer}_final"] = got[-1].tolist()
    return out


def _localisation_cli() -> dict:
    """Phase 13 (d): the localisation CLI on the committed recording with
    the fewest control steps, held to the fixture. ``locbench.check``
    passes when one seed lies inside the JAX seeds' bounds, so the seeds
    run in turn until one does (the same verdict as running them all)."""
    import contextlib
    import io

    from acmpc_tpu_torch.bench import locbench
    from acmpc_tpu_torch.cli import benchmark_localisation

    track = locbench.track_of(LOC_CLI_RECORDING)
    fixture = locbench.load_fixture()
    rows = []
    for seed in LOC_SEEDS:
        argv = [
            "--config", str(ROOT / "configs" / f"{track}.yaml"),
            "--data", str(ROOT / "data" / "localisation" / LOC_CLI_RECORDING / "racing"),
            "--map", str(ROOT / "data" / "maps" / f"{track}.npz"),
            "--seed", str(seed), "--device", DEVICE,
        ]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            summary = benchmark_localisation.main(argv)
        rows.append({"recording": LOC_CLI_RECORDING, "seed": seed, "max_steps": None,
                     **summary, "wall_s": time.perf_counter() - t0})
        if "Percentage of time localised" not in printed.getvalue():
            raise RuntimeError("the localisation CLI printed no report")
        if locbench.seeds_inside(rows, fixture):
            break
    fails = locbench.check(rows, fixture)
    if fails:
        raise RuntimeError(f"localisation CLI outside the JAX fixture's bounds: {fails}; {rows}")
    return {"seeds_inside": locbench.seeds_inside(rows, fixture), "rows": rows}


def phase_tools(agent: dict) -> dict:
    """Phase 13: the raceline, the Pacejka model, the dashboard on the
    racing agent and the localisation CLI."""
    from acmpc_tpu_torch.bench import agent_loop

    t_phase = time.perf_counter()
    info: dict = {"raceline": _racelines(), "pacejka": _pacejka()}
    run = agent_loop.racing_run(DASHBOARD_FRAMES, DEVICE, dashboard=True)
    if run["fails"]:
        raise RuntimeError(f"racing with the dashboard failed its gates: {run['fails']}; {run}")
    alone = agent["racing"]
    info["dashboard"] = {
        **{k: run[k] for k in ("frames", "seconds", "distance_m", "max_offtrack_m", "launches")},
        **run["dashboard"],
        "with_dashboard": {k: run[k] for k in ("solves_per_s", "behaviour_p50_ms", "behaviour_p99_ms", "sim_step_p50_ms")},
        "phase12_without": {k: alone[k] for k in ("solves_per_s", "behaviour_p50_ms", "behaviour_p99_ms", "sim_step_p50_ms")},
    }
    info["localisation_cli"] = _localisation_cli()
    info["not_run"] = "cli/view_map and the --figure / --plot options need matplotlib, absent on the card machine"
    launches = collections.Counter(info["raceline"]["launches"])
    launches.update(run["launches"])
    info["launches"] = dict(launches)
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 13 tools and dashboard", info)
    return info


def _parallel_world_of_one() -> dict:
    """(a): an NCCL process group of one rank, made and destroyed here:
    the sharded control step on phase 4's inputs against the fused step
    on the same inputs, and the sharded map profile against the
    unsharded one."""
    import torch
    import torch.distributed as dist

    from acmpc_tpu_torch.bench.pod_sweep import max_ulps, profile_path
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, CLUSTER_BOX_ACTIVE
    from acmpc_tpu_torch.parallel import make_mesh, sharded_get_control
    from acmpc_tpu_torch.parallel.multihost import start_process_group

    mpc = make_mpc("monza", DEVICE)
    skipping = make_mpc("monza", DEVICE)
    skipping.admm = dataclasses.replace(skipping.admm, tile_skip=True)
    refs = torch.as_tensor(difficulty_ramp(HORIZON, BATCH), device=DEVICE)
    states0 = mpc.initial_state(BATCH)
    fused = [skipping.batched_get_control_fused(states0, refs)[0]]
    for _ in range(5):
        fused.append(mpc.batched_get_control_fused(fused[-1], refs)[0])
    limits = load_config(ROOT / "configs" / "monza.yaml").map_speed_profile
    path = profile_path(mpc, "synth_nordschleife")
    single = mpc.compute_map_speed_profile(path, limits.ay_max, limits.a_min).velocities

    start_process_group(None, 1, 0, device=DEVICE, backend="nccl")
    try:
        mesh = make_mesh(device=DEVICE)
        cold, warm = sharded_get_control(skipping, mesh), sharded_get_control(mpc, mesh)

        def drive():
            steps, fleets = [], []
            for i in range(6):
                new, fleet = (warm if steps else cold)(steps[-1] if steps else states0, refs)
                steps.append(new)
                fleets.append({k: float(v) for k, v in fleet.items()})
            return steps, fleets

        (steps, fleets), launches = _counted(drive)
        sharded = mpc.compute_map_speed_profile(path, limits.ay_max, limits.a_min, mesh=mesh).velocities
        backend, calls = mesh.backend, dict(mesh.calls)
    finally:
        dist.destroy_process_group()

    if backend != "nccl":
        raise RuntimeError(f"parallel (a): backend {backend}")
    solved = [int(f["n_solved"]) for f in fleets]
    if solved != [BATCH] * 6:
        raise RuntimeError(f"parallel (a): n_solved per step {solved}, not {BATCH}")
    for name in (CLUSTER_BOX, CLUSTER_BOX_ACTIVE):
        if launches.get(name, 0) == 0:
            raise RuntimeError(f"parallel (a): never launched {name}")
    err = max(float((s.projected_control - f.projected_control).abs().max()) for s, f in zip(steps, fused))
    if err != 0.0:
        raise RuntimeError(f"parallel (a): the sharded step is not the fused step: {err}")
    if not torch.equal(sharded, single):
        ulps = max_ulps(sharded.cpu().numpy(), single.cpu().numpy())
        raise RuntimeError(f"parallel (a): the world-of-one map profile differs by {ulps} ulps")
    return {
        "backend": backend,
        "batch": BATCH,
        "n_solved_per_step": solved,
        "worst_r_prim": max(f["worst_r_prim"] for f in fleets),
        "max_abs_err_vs_fused": err,
        "launches": launches,
        "collective_calls": calls,
        "map_points": int(single.shape[0]),
        "map_profile_bit_equal": True,
    }


def _parallel_ranks() -> dict:
    """(b) and (c): two ranks sharing the card over gloo, spawned here
    (one launch runs both cases), against one process; then the launch
    CLI in both of its modes."""
    from acmpc_tpu_torch.bench import pod_sweep
    from acmpc_tpu_torch.cli.launch_pod import run_two_process_smoke
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX

    t0 = time.perf_counter()
    results = pod_sweep.launch(("sweep", "profiles"), PARALLEL_RANKS, DEVICE, "gloo")
    launch_s = time.perf_counter() - t0

    # (b) the sweep
    one = pod_sweep.single_sweep(DEVICE, pod_sweep.SCENARIOS_PER_RANK * PARALLEL_RANKS)
    sweep = pod_sweep.compare("sweep", results["sweep"], one)
    n_solves = pod_sweep.SCENARIOS_PER_RANK * PARALLEL_RANKS * pod_sweep.STEPS
    for r, rank in enumerate(sweep["ranks"]):
        # a rank counts its chunks alone (bench/pod_sweep.py)
        _check_closed_loop(f"parallel (b) rank {r}", {CLUSTER_BOX: pod_sweep.STEPS}, rank["launches"],
                           rank["n_solved"] / rank["n_solves"], 0.99)
        if rank["n_solves"] != n_solves:
            raise RuntimeError(f"parallel (b) rank {r}: n_solves {rank['n_solves']}, not {n_solves}")
    v = np.concatenate([arrays["v"] for _, arrays in results["sweep"]])
    if not np.allclose(v, one["v"], **LOOP_TOL):
        raise RuntimeError(f"parallel (b): two ranks' speeds {sweep['max_abs_v_err']} from one process's")

    # (c) the horizon-sharded profiles
    single = pod_sweep.single_profiles(DEVICE)
    profiles = pod_sweep.compare("profiles", results["profiles"], single)
    for name in pod_sweep.PROFILE_MAPS:
        if profiles[f"map_{name}_max_ulps"] > REAL_MAP_ULPS:
            raise RuntimeError(f"parallel (c): {name}: {profiles[f'map_{name}_max_ulps']} ulps")
    for r, (rank, arrays) in enumerate(results["profiles"]):
        if rank["admm_status"] != 1 or rank["admm_iterations"] != single["admm_iterations"]:
            raise RuntimeError(
                f"parallel (c) rank {r}: ADMM status {rank['admm_status']} in "
                f"{rank['admm_iterations']} iterations, one process {single['admm_iterations']}"
            )
    admm_v = np.concatenate([arrays["admm_v"] for _, arrays in results["profiles"]])
    if not np.allclose(admm_v, single["admm_v"], **ADMM_TOL):
        raise RuntimeError(f"parallel (c): ADMM velocities {profiles['admm_max_abs_err']} apart")

    # the launch CLI, as tests/test_multiprocess_distributed.py checks it
    cli_sweep = run_two_process_smoke(device=DEVICE, backend="gloo")
    got = [cli_sweep[k] for k in ("hosts", "chips", "mesh", "scenarios", "success_rate")]
    if got != [2, 2, {"host": 2, "chip": 1}, 4, 1.0] or not cli_sweep["solves_per_s"] > 0:
        raise RuntimeError(f"parallel: launch CLI sweep {cli_sweep}")
    cli_lap = run_two_process_smoke(
        scenarios_per_chip=1, steps=CLI_LAP_STEPS, full_lap=True, device=DEVICE, backend="gloo"
    )
    got = [cli_lap[k] for k in ("mode", "hosts", "total_solves", "solve_success_rate", "completed_laps")]
    if got != ["full_lap", 2, cli_lap["scenarios"] * CLI_LAP_STEPS, 1.0, 0]:
        raise RuntimeError(f"parallel: launch CLI full lap {cli_lap}")
    return {
        "launch_s": launch_s,
        "sweep": sweep,
        "launches": [rank["launches"] for rank in sweep["ranks"]],
        "profiles": profiles,
        "cli_sweep": cli_sweep,
        "cli_full_lap": cli_lap,
    }


def _pcr_bound(n: int, rhs: int = 1) -> tuple[float, str]:
    """Least time of a PCR solve of ``rhs`` systems of n rows on an H100:
    sub, diag, sup, rhs read and x written once, against ~12 fp32
    operations a row a step over ceil(log2 n) steps."""
    n_bytes = 4 * n * (3 + 2 * rhs)
    flops = rhs * n * (12 * int(np.ceil(np.log2(n))) + 1)
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def _spd_bound(batch: int, n: int) -> tuple[float, str]:
    """Least time of ``spd_inverse`` on (batch, n, n): K read and M written
    once, against the recursion's matmuls (4/3 p^3 at the padded size p)
    and two polishes (8 n^3)."""
    p = 1 << (n - 1).bit_length()
    n_bytes = 2 * 4 * batch * n * n
    flops = batch * (4 * p**3 / 3 + 8 * n**3)
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def _parallel_ops(ranks: dict) -> dict:
    """(d): the ops alone, on the card against the CPU: PCR at N = 43,940,
    the SPIKE solve at two ranks (timed in the ranks), and spd_inverse at
    (256, 248, 248) on real horizon-50 KKT matrices beside the Cholesky
    route (``_factor``) on the same matrices."""
    import torch

    from acmpc_tpu_torch.bench.pod_sweep import SPIKE_N, launches_per_call, spike_system
    from acmpc_tpu_torch.ops import spd_inverse, tridiag_solve
    from acmpc_tpu_torch.qp.admm import _factor, _rho_vector, _ruiz_equilibrate

    cpu_parts = [torch.as_tensor(a) for a in spike_system()]
    parts = [a.to(DEVICE) for a in cpu_parts]
    pcr_err = float((tridiag_solve(*parts).cpu() - tridiag_solve(*cpu_parts)).abs().max())
    if pcr_err > 1e-6:
        raise RuntimeError(f"parallel (d): PCR on the card {pcr_err} from the CPU")
    pcr_bound, pcr_by = _pcr_bound(SPIKE_N)
    profiles = ranks["profiles"]
    spike_bound, spike_by = _pcr_bound(SPIKE_N // PARALLEL_RANKS, rhs=3)
    if profiles["spike_max_abs_err"] > 1e-5:
        raise RuntimeError(f"parallel (d): SPIKE {profiles['spike_max_abs_err']} from PCR")
    # the interface system's solve alone: 2S x 2S, one call of the library
    interface = torch.eye(2 * PARALLEL_RANKS, device=DEVICE) * 2.0 + 0.1
    rhs = torch.ones(2 * PARALLEL_RANKS, 1, device=DEVICE)

    mpc = make_mpc("monza", DEVICE)
    refs = torch.as_tensor(difficulty_ramp(HORIZON, BATCH), device=DEVICE)
    zeros = torch.zeros(BATCH, device=DEVICE)
    _, _, (P, q, A, l, u) = mpc._prepare(
        mpc.initial_state(BATCH), refs, torch.full((BATCH,), mpc.config.constraints.v_max, device=DEVICE),
        torch.zeros(BATCH, dtype=torch.bool, device=DEVICE), zeros,
    )
    Ps, _, As, _, _, e = _ruiz_equilibrate(P, q, A, mpc.admm.scaling_iters)
    rho = _rho_vector(torch.tensor(mpc.admm.rho, device=DEVICE), e * l, e * u)
    sigma = mpc.admm.sigma
    n = P.shape[-1]
    eye = torch.eye(n, device=DEVICE)
    K = Ps + sigma * eye + (As.transpose(-1, -2) * rho[..., None, :]) @ As
    M_spd = spd_inverse(K)
    M_chol = _factor(Ps, As, rho, sigma)
    r_spd = float((eye - K @ M_spd).abs().amax(dim=(1, 2)).max())
    r_chol = (eye - K @ M_chol).abs().amax(dim=(1, 2))
    ratio = float(((eye - K @ M_spd).abs().amax(dim=(1, 2)) / torch.clamp(r_chol, min=1e-6)).max())
    spd_vs_chol = float((M_spd - M_chol).abs().max() / M_chol.abs().max())
    cpu_idx = torch.arange(0, BATCH, BATCH // 8, device=DEVICE)
    spd_cpu_err = float(
        (spd_inverse(K[cpu_idx].cpu()) - M_spd[cpu_idx].cpu()).abs().max() / M_spd.abs().max().cpu()
    )
    if r_spd >= 1e-3 or ratio > 10.0 or spd_cpu_err > 1e-3:
        raise RuntimeError(
            f"parallel (d): spd_inverse residual {r_spd}, {ratio}x the Cholesky route's, "
            f"card against CPU {spd_cpu_err}"
        )
    spd_bound, spd_by = _spd_bound(BATCH, n)
    return {
        "pcr": {
            "n": SPIKE_N, "ms": time_cuda_ms(lambda: tridiag_solve(*parts), 20),
            "launches": launches_per_call(lambda: tridiag_solve(*parts)),
            "max_abs_err_vs_cpu": pcr_err, "bound_ms": pcr_bound, "bound_by": pcr_by, "library_ms": None,
        },
        "spike": {
            "n": SPIKE_N, "ranks": PARALLEL_RANKS,
            "ms": max(r["spike_ms"] for r in profiles["ranks"]),
            "launches": profiles["ranks"][0].get("spike_launches"),
            "max_abs_err_vs_pcr": profiles["spike_max_abs_err"],
            "bound_ms": spike_bound, "bound_by": spike_by,
            "library_ms": time_cuda_ms(lambda: torch.linalg.solve(interface, rhs), 50),
            "psum_ms": [r["psum_ms"] for r in profiles["ranks"]],
            "shift_ms": [r["shift_ms"] for r in profiles["ranks"]],
        },
        "spd_inverse": {
            "shape": list(K.shape),
            "ms": time_cuda_ms(lambda: spd_inverse(K), 10),
            "launches": launches_per_call(lambda: spd_inverse(K)),
            "residual_max": r_spd, "residual_vs_cholesky_max": ratio,
            "rel_err_vs_cholesky": spd_vs_chol, "rel_err_vs_cpu": spd_cpu_err,
            "bound_ms": spd_bound, "bound_by": spd_by,
            "factor_ms": time_cuda_ms(lambda: _factor(Ps, As, rho, sigma), 10),
            "factor_launches": launches_per_call(lambda: _factor(Ps, As, rho, sigma)),
            "library_inv_ms": time_cuda_ms(lambda: torch.linalg.inv(K), 10),
            "library_cholesky_inverse_ms": time_cuda_ms(
                lambda: torch.cholesky_inverse(torch.linalg.cholesky(K)), 10
            ),
        },
    }


def phase_parallel() -> dict:
    t0 = time.perf_counter()
    world_of_one = _parallel_world_of_one()
    ranks = _parallel_ranks()
    ops = _parallel_ops(ranks)
    launches = collections.Counter(world_of_one["launches"])
    for counts in ranks["launches"]:
        launches.update(counts)
    info = {
        "world_of_one": world_of_one,
        **{k: v for k, v in ranks.items() if k != "launches"},
        "rank_launches": ranks["launches"],
        "ops": ops,
        "launches": dict(launches),
        "wall_s": time.perf_counter() - t0,
        "card": card_line(),
    }
    emit("phase 14 parallel", info)
    return info


def _lane(tree, i):
    """Lane ``i`` of a dataclass of batched tensors."""
    return type(tree)(*(getattr(tree, f.name)[i] for f in dataclasses.fields(tree)))


def _lanes_against_single(mpc, before, after, diags, refs, lanes) -> dict:
    """Lanes of one ``batched_get_control`` step (``before`` -> ``after``)
    against ``get_control`` on each lane alone from the same state: the
    largest command difference, and the lanes whose status or iteration
    count differ."""
    err, differ = np.zeros(2), []
    for i in lanes:
        one, one_diags = mpc.get_control(_lane(before, i), refs[i])
        diff = (one.projected_control - after.projected_control[i]).abs().amax(dim=-1)
        err = np.maximum(err, diff.cpu().numpy())
        if (int(one_diags.control_status), int(one_diags.control_iterations)) != (
            int(diags.control_status[i]), int(diags.control_iterations[i])
        ):
            differ.append(int(i))
    return {
        "max_abs_err": float(err.max()),
        "max_abs_err_speed": float(err[0]),
        "max_abs_err_steering": float(err[1]),
        "command_scale": float(after.projected_control[lanes].abs().amax()),
        "lanes_differing": differ,
    }


def _batched_steps(mpc, refs, n_steps: int):
    """``n_steps`` of ``batched_get_control`` from zero states, each timed
    and ended by a synchronise: (states before each step and after the
    last, diagnostics, walls in s)."""
    import torch

    states, diags, walls = [mpc.initial_state(refs.shape[0])], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, d = mpc.batched_get_control(states[-1], refs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        states.append(new)
        diags.append(d)
    return states, diags, walls


def _check_steps(label: str, states, batch: int, horizon: int):
    for i, s in enumerate(states[1:]):
        if not bool(s.solved.all()):
            raise RuntimeError(f"{label} step {i}: {int((~s.solved).sum())} of {batch} unsolved")
        if not _finite(s.projected_control) or s.projected_control.shape != (batch, 2, horizon - 1):
            raise RuntimeError(f"{label} step {i}: commands {tuple(s.projected_control.shape)} or not finite")


def _vmapped_racing() -> dict:
    """(a): phase 4's inputs through ``batched_get_control``, cold then
    five warm steps; lanes against get_control alone, every lane against
    the fused engine, 8 lanes against the CPU."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX, CLUSTER_BOX_ACTIVE

    mpc = make_mpc("monza", DEVICE)
    refs = torch.as_tensor(difficulty_ramp(HORIZON, BATCH), device=DEVICE)
    (states, diags, walls), launches = _counted(lambda: _batched_steps(mpc, refs, 6))
    _check_steps("vmapped racing", states, BATCH, HORIZON)
    for name in (CLUSTER_BOX, CLUSTER_BOX_ACTIVE):
        if launches.get(name, 0) == 0:
            raise RuntimeError(f"vmapped racing never launched {name}")

    pick = torch.arange(0, BATCH, BATCH // VMAP_LANES)
    single = {
        "cold": _lanes_against_single(mpc, states[0], states[1], diags[0], refs, pick),
        "warm": _lanes_against_single(mpc, states[-2], states[-1], diags[-1], refs, pick),
    }
    for k, v in single.items():
        if v["lanes_differing"] or v["max_abs_err"] > VMAP_LANE_TOL:
            raise RuntimeError(f"vmapped racing {k}: lanes against get_control alone: {v}")

    fused, fused_err = [mpc.initial_state(BATCH)], 0.0
    for i in range(6):
        fused.append(mpc.batched_get_control_fused(fused[-1], refs)[0])
        fused_err = max(fused_err, float(
            (fused[-1].projected_control - states[i + 1].projected_control).abs().max()
        ))
        if int(fused[-1].solved.sum()) != int(states[i + 1].solved.sum()) or fused_err > VMAP_TOL:
            raise RuntimeError(f"vmapped racing step {i}: the fused engine differs by {fused_err}")

    cpu_mpc = make_mpc("monza", "cpu")
    cpu_state, _ = cpu_mpc.batched_get_control(cpu_mpc.initial_state(len(pick)), refs[pick].cpu())
    cpu_err = float((cpu_state.projected_control - states[1].projected_control[pick].cpu()).abs().max())
    if not bool(cpu_state.solved.all()) or cpu_err > VMAP_TOL:
        raise RuntimeError(f"vmapped racing: card and CPU disagree: max abs err {cpu_err}")
    warm_ms = 1e3 * float(np.median(walls[1:]))
    return {
        "config": "monza racing, horizon 50",
        "batch": BATCH,
        "launches": launches,
        "cold_ms": 1e3 * walls[0],
        "warm_ms_per_step": warm_ms,
        "warm_step_ms_all": [1e3 * w for w in walls[1:]],
        "solves_per_s": BATCH / (warm_ms / 1e3),
        "iterations_cold": [int(diags[0].control_iterations.min()), int(diags[0].control_iterations.max())],
        "iterations_warm_max": int(diags[-1].control_iterations.max()),
        "against_single": single,
        "fused_max_abs_err": fused_err,
        "cpu_plain_max_abs_err": cpu_err,
    }


def _vmapped_random_qps() -> dict:
    """(b): B random QPs at n = 248, m = 398 with adaptive rho, each lane
    against its unbatched solve on the card."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER
    from acmpc_tpu_torch.qp.admm import ADMMConfig, _solve_lanes, _solve_one

    cfg = ADMMConfig()
    qps, _ = random_box_qps(VMAP_QPS, *H50, seed=11, device=DEVICE)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _solve_lanes(*qps, cfg, None, None)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ((batch, rho), wall), launches = _counted(solve)
    t0 = time.perf_counter()
    singles = [_solve_one(*(t[i] for t in qps), cfg, None, None) for i in range(VMAP_QPS)]
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    status = torch.stack([s.status for s, _ in singles])
    if not torch.equal(status, batch.status) or not bool(batch.solved.all()):
        raise RuntimeError(f"vmapped QPs: statuses {batch.status.tolist()} against {status.tolist()}")
    x = torch.stack([s.x for s, _ in singles])
    scale = max(1.0, float(x.abs().max()))
    err = float((x - batch.x).abs().max())
    if err > VMAP_QP_TOL * scale:
        raise RuntimeError(f"vmapped QPs: lanes {err} from single solves")
    single_rho = torch.stack([r for _, r in singles])
    single_its = torch.stack([s.iterations for s, _ in singles])
    # random A of no known layout: the dense operator
    if launches.get(CLUSTER, 0) == 0 or any("[box" in k for k in launches):
        raise RuntimeError(f"vmapped QPs: launches {launches}, not the dense cluster kernel's")
    return {
        "batch": VMAP_QPS,
        "n": H50[0],
        "m": H50[1],
        "lanes_refactored": int((rho != cfg.rho).sum()),
        "lanes_rho_equal_single": int((rho == single_rho).sum()),
        "lanes_iterations_equal_single": int((batch.iterations == single_its).sum()),
        "iterations": [int(batch.iterations.min()), int(batch.iterations.max())],
        "max_abs_err_vs_single": err,
        "x_scale": scale,
        "launches": launches,
        "wall_ms": 1e3 * wall,
        "single_solves_wall_ms": 1e3 * single_wall,
    }


def _vmapped_mapping() -> dict:
    """(c): monza's mapping control (horizon 100) at B = 8 through
    ``batched_get_control``, in a cluster on the box block; lanes against
    get_control alone."""
    import torch

    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX

    mpc = make_mpc("monza", DEVICE, mode="mapping")
    horizon = mpc.config.horizon
    refs = torch.as_tensor(difficulty_ramp(horizon, BATCH)[:MAPPING_BATCH], device=DEVICE)
    (states, diags, walls), launches = _counted(lambda: _batched_steps(mpc, refs, 6))
    _check_steps("vmapped mapping", states, MAPPING_BATCH, horizon)
    if launches.get(CLUSTER_BOX, 0) == 0 or any(k.startswith("admm_chunk_split") for k in launches):
        raise RuntimeError(f"vmapped mapping: launches {launches}, not the box-block cluster kernel's")
    lanes = torch.arange(MAPPING_BATCH)
    single = {
        "cold": _lanes_against_single(mpc, states[0], states[1], diags[0], refs, lanes),
        "warm": _lanes_against_single(mpc, states[-2], states[-1], diags[-1], refs, lanes),
    }
    for k, v in single.items():
        if v["lanes_differing"] or v["max_abs_err"] > VMAP_LANE_TOL:
            raise RuntimeError(f"vmapped mapping {k}: lanes against get_control alone: {v}")
    return {
        "config": f"monza mapping, horizon {horizon}",
        "batch": MAPPING_BATCH,
        "launches": launches,
        "cold_ms": 1e3 * walls[0],
        "warm_ms_per_step": 1e3 * float(np.median(walls[1:])),
        "against_single": single,
    }


def _vmapped_lap_sweep() -> dict:
    """(d): ``LapSweep.run`` on phase 8's grid against ``run_fused``."""
    import torch

    from acmpc_tpu_torch.bench.full_lap import HALF_WIDTH, MAP, closed_loop_mpc
    from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
    from acmpc_tpu_torch.localise.track_map import load_track_map

    mpc = closed_loop_mpc(DEVICE)
    tm = load_track_map(MAP, device=DEVICE)
    sweep = LapSweep(mpc, tm, half_width=HALF_WIDTH, dt=0.1)
    grid = SweepGrid.perturbed(
        torch.Generator(device=DEVICE).manual_seed(0), SWEEP_BATCH, tm.n_centre, v_max=24.0
    )

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = run(grid, SWEEP_STEPS)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    # untimed first, then in turns: run, fused, fused, run
    sweep.run(grid, SWEEP_STEPS)
    (metrics, wall), launches = _counted(lambda: timed(sweep.run))
    fused, fused_wall = timed(sweep.run_fused)
    fused_wall = (fused_wall + timed(sweep.run_fused)[1]) / 2
    wall = (wall + timed(sweep.run)[1]) / 2
    summary = sweep.summarise(metrics, SWEEP_STEPS)
    _check_closed_loop("vmapped sweep", _per_step(SWEEP_STEPS), launches, summary["solve_success_rate"], 0.99)
    if not torch.equal(metrics["solved"], fused["solved"]):
        raise RuntimeError("vmapped sweep: solved flags differ from run_fused's")
    err = max(float((metrics[k] - fused[k]).abs().max()) for k in ("v", "offtrack"))
    if err > VMAP_TOL:
        raise RuntimeError(f"vmapped sweep: metrics {err} from run_fused's")
    solves = SWEEP_BATCH * SWEEP_STEPS
    return {
        "batch": SWEEP_BATCH,
        "steps": SWEEP_STEPS,
        "launches": launches,
        "closed_loop_solves_per_s": solves / wall,
        "fused_closed_loop_solves_per_s": solves / fused_wall,
        "wall_s": wall,
        "fused_wall_s": fused_wall,
        "max_abs_err_vs_fused": err,
        "solve_success_rate": summary["solve_success_rate"],
    }


def _vmapped_sub_mesh() -> dict:
    """(e): ``make_mesh(1)`` at two gloo ranks sharing the card
    (``bench/pod_sweep.py``'s submesh case)."""
    from acmpc_tpu_torch.bench import pod_sweep
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX

    t0 = time.perf_counter()
    (member, arrays), (outsider, _) = pod_sweep.launch(("submesh",), PARALLEL_RANKS, DEVICE, "gloo")["submesh"]
    launch_s = time.perf_counter() - t0
    rows = len(pod_sweep.SUBMESH_WINDOWS)
    if (member["is_member"], member["rows"], member["n_solved"]) != (True, rows, rows):
        raise RuntimeError(f"sub-mesh rank 0: {member}")
    if member["launches"].get(CLUSTER_BOX, 0) == 0:
        raise RuntimeError(f"sub-mesh rank 0 never launched {CLUSTER_BOX}: {member['launches']}")
    err = float(np.abs(arrays["projected_control"] - arrays["batched"]).max())
    if err > VMAP_LANE_TOL:
        raise RuntimeError(f"sub-mesh: sharded_get_control {err} from batched_get_control")
    error = outsider.get("error", "")
    if outsider["is_member"] or outsider["rows"] != 0 or not ("rank 1 " in error and "mesh of 1 ranks" in error):
        raise RuntimeError(f"sub-mesh rank 1: {outsider}")
    return {
        "launch_s": launch_s,
        "rank0": member,
        "rank1": outsider,
        "max_abs_err_vs_batched": err,
        "launches": member["launches"],
    }


def phase_vmapped() -> dict:
    t0 = time.perf_counter()
    parts = {
        "racing": _vmapped_racing(),
        "random_qps": _vmapped_random_qps(),
        "mapping": _vmapped_mapping(),
        "lap_sweep": _vmapped_lap_sweep(),
        "sub_mesh": _vmapped_sub_mesh(),
    }
    launches = collections.Counter()
    for part in parts.values():
        launches.update(part["launches"])
    info = {**parts, "launches": dict(launches), "wall_s": time.perf_counter() - t0, "card": card_line()}
    emit("phase 15 vmapped", info)
    return info


def _sha256(path: pathlib.Path) -> str:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest()


def _percentiles(ms: list) -> dict:
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)), "p90": float(np.percentile(a, 90)), "mean": float(a.mean())}


def phase_training() -> dict:
    """The segmenter's trainer on the card: (a) one step against the CPU;
    (b) ``cli/train_segmenter.main`` at the JAX tool's defaults, its IoU
    gate, the step's split, rate, memory, FLOPs and busy share; (c) the
    checkpoint it wrote, at 1280x736 in fp32 and bf16 and in the
    camera-to-command loop; the shipped checkpoint untouched."""
    import torch

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.bench import train_step as bench
    from acmpc_tpu_torch.bench.full_lap import closed_loop_mpc
    from acmpc_tpu_torch.cli import train_segmenter as ts
    from acmpc_tpu_torch.models.checkpoint import read_checkpoint
    from acmpc_tpu_torch.ops import track_chain as chain
    from acmpc_tpu_torch.ops.admm_chunk import CLUSTER_BOX
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.segmentation import TrackSegmenter

    t_phase = time.perf_counter()
    shipped_sha = _sha256(SHIPPED_FPN)
    info: dict = {}
    # (a) one step on the card against the CPU from the same variables:
    # the trainer's start, and one drawn with a torch.Generator
    sim, rng = ts.make_sim(0)
    images, masks = ts.sample_frames(sim, rng, TRAIN_CHECK_BATCH)
    info["card_vs_cpu"] = {"shape": [TRAIN_CHECK_BATCH, ts.TRAIN_H, ts.TRAIN_W]}
    for start, variables in (("flax:0", ts.init_variables(0)), ("torch:0", bench.torch_draws(0))):
        records = {}
        for dev in ("cpu", DEVICE):
            model = ts.make_model(variables, dev)
            opt = ts.make_optimizer(model, ts.LR)
            records[dev] = bench.step_record(
                model, opt, torch.as_tensor(images, device=dev), torch.as_tensor(masks, device=dev)
            )
        errors = bench.compare_records(records[DEVICE], records["cpu"], ts.LR, bench.CARD_GRAD_RTOL)
        # each side's gradients against an fp64 step from the same variables
        exact = bench.fp64_gradients(variables, images, masks)
        errors["against_fp64"] = {dev: bench.gradient_error(records[dev]["grads"], exact) for dev in records}
        if errors["fails"]:
            raise RuntimeError(f"training step from {start}, card against CPU: {errors['fails'][:5]}")
        info["card_vs_cpu"][start] = errors

    # (b) the trainer as a user runs it, at the tool's defaults
    torch.cuda.reset_peak_memory_stats()
    run = ts.main([], device=DEVICE)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(row["loss"]) for row in run.log):
        raise RuntimeError(f"training loss not finite: {run.log}")
    steps, batch = ts.STEPS, ts.BATCH
    step_ms = _percentiles(run.step_ms)
    # after the checkpoint is written: synchronised steps, the FLOP
    # count and the profile continue training the same model
    frames = [torch.as_tensor(a, device=DEVICE) for a in ts.sample_frames(sim, rng, batch)]
    synced = _percentiles(bench.synced_step_ms(run.model, run.optimizer, *frames, TRAIN_SYNCED_STEPS))
    flops = bench.count_flops(run.model, run.optimizer, *frames)

    def loop_step():
        batch_frames = ts.sample_frames(sim, rng, batch)
        ts.train_step(run.model, run.optimizer, *(torch.as_tensor(a, device=DEVICE) for a in batch_frames))

    profile = bench.profile_steps(loop_step, TRAIN_PROFILE_STEPS, torch.device(DEVICE))
    bound_ms = 1e3 * flops / FP32_FLOP_PER_S
    info["train"] = {
        "steps": steps,
        "batch": batch,
        "log": run.log,
        "final_val_iou": run.final_iou,
        "wall_s": run.wall_s,
        "eval_s": run.eval_s,
        "images_per_s": batch * steps / run.wall_s,
        "sample_ms": _percentiles(run.sample_ms),
        "device_step_ms": step_ms,
        "synced_step_ms": synced,
        "device_images_per_s": batch / (step_ms["p50"] / 1e3),
        "peak_memory_gib": peak / 2**30,
        "flop_per_step": flops,
        "xla_flop_per_step": XLA_STEP_FLOP,
        "achieved_tflop_per_s": flops / (step_ms["p50"] / 1e3) / 1e12,
        "achieved_tflop_per_s_xla_count": XLA_STEP_FLOP / (step_ms["p50"] / 1e3) / 1e12,
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "bound_share": bound_ms / step_ms["p50"],
        "profile": profile,
    }

    # (c) the checkpoint it wrote, through the port's loaders
    out = ts.DEFAULT_OUT
    cfg = dataclasses.replace(loop.perception_config(), model_path=str(out))
    centre, left, right, lap_m = loop.circuit()
    big_sim = loop.make_sim(cfg, centre, left, right)
    frames, truths = loop.sim_frames(big_sim, centre, TRAIN_IOU_FRAMES)
    iou = {}
    for label, path, precision in (
        ("fp32", out, "fp32"), ("bf16", out, "bf16"), ("shipped_fp32", SHIPPED_FPN, "fp32")
    ):
        seg = TrackSegmenter(dataclasses.replace(cfg, model_path=str(path), precision=precision), device=DEVICE)
        preds = [seg.segment_drivable_area(f)[0].cpu().numpy() for f in frames]
        iou[label] = _iou(np.stack(preds), np.stack(truths))
    if min(iou["fp32"], iou["bf16"]) <= IOU_MIN:
        raise RuntimeError(f"trained checkpoint at {cfg.image_width}x{cfg.image_height}: IoU {iou} <= {IOU_MIN}")
    perc = Perceiver(cfg, read_checkpoint(out), DEVICE)
    mpc = closed_loop_mpc(DEVICE)
    loop_run, launches = _counted(lambda: loop.perception_in_loop(perc, mpc, big_sim, centre, lap_m, LOOP_FRAMES))
    if loop_run["solve_success"] != 1.0:
        raise RuntimeError(f"trained checkpoint's loop: solve success {loop_run['solve_success']}")
    if not loop_run["max_offtrack_m"] < loop.HALF_WIDTH:
        raise RuntimeError(f"trained checkpoint's loop: the car left the track by {loop_run['max_offtrack_m']} m")
    # the warm frame captures the new perceiver's graph: its warm-up
    # launches the chain-edges kernel once more
    warm = 1 + loop_run["captured_warm_frame"]
    if launches.get(chain.TRACK_CHAIN_EDGES, 0) != loop_run["frames"] + warm or launches.get(CLUSTER_BOX, 0) == 0:
        raise RuntimeError(f"trained checkpoint's loop: launches {launches} for {loop_run['frames']} + {warm} frames")
    if _sha256(SHIPPED_FPN) != shipped_sha:
        raise RuntimeError("the shipped checkpoint changed during the training phase")
    info["checkpoint"] = {
        "path": str(out.relative_to(ROOT)),
        "stored_dtypes": sorted({str(v.dtype) for v in _flat_leaves(read_checkpoint(out))}),
        "resolution": f"{cfg.image_width}x{cfg.image_height}",
        "frames": TRAIN_IOU_FRAMES,
        "iou": iou,
        "loop": {k: v for k, v in loop_run.items() if k != "ms_all"},
        "shipped_sha256": shipped_sha,
    }
    info["launches"] = launches
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 16 training", info)
    return info


def phase_compiled() -> dict:
    """The compiled entries (``ops/graph_loop.py``): the loop kernel's
    row; 200 closed-loop B = 1 steps of the racing (horizon 50) and the
    mapping (horizon 100) control through ``jitted_get_control`` against
    ``get_control``, bit-equal, with a step that runs to ``max_iter`` and
    a step that fails, the replays' launches exact; the golden battery
    through ``jitted_get_control``; a replay with host synchronisations an
    error; a capture that reads the card raising; the perceiver's graphs
    against eager at 1280x736 bf16 (``_pipeline``, and the card path's
    ``_raw_pipeline`` against the plain JPEG round trip then
    ``_run_pipeline``); the eager-against-captured timings."""
    import torch

    from acmpc_tpu_torch.bench import graph_entries as ge
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.ops import graph_loop
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.segmentation import TrackSegmenterAOT

    t_phase = time.perf_counter()
    info: dict = {"cuda": graph_loop.cuda_versions()}
    # the loop kernel: the trips it counted and its launches in a replay
    info["loop"] = ge.loop_row()
    if info["loop"]["max_abs_err"] != 0:
        raise RuntimeError(f"device_while's trip count or launches are off: {info['loop']}")

    # (a) the closed loops, eager against captured
    launches = collections.Counter()
    for mode in ("racing", "mapping"):
        run = ge.compare_loops(mode, COMPILED_STEPS, DEVICE)
        if not run["bit_equal"]:
            raise RuntimeError(f"{mode}: captured steps differ from eager: {run['mismatches']}")
        if run["max_iter_exits"] < 1 or run["unsolved_steps"] < 1:
            raise RuntimeError(f"{mode}: no max_iter exit or no failed step: {run}")
        for name in ("eager", "captured"):
            got = run["launches"][name]
            if got != run["launches_expected"][name]:
                raise RuntimeError(f"{mode} {name}: launches {got}, expected {run['launches_expected'][name]}")
        launches.update(run["launches"]["captured"])
        info[f"{mode}_loop"] = run

    # (b) the golden battery through the compiled step
    golden = np.load(ROOT / "tests" / "fixtures" / "golden_controls.npz")
    worst = 0.0
    for track in TRACKS:
        mpc = make_mpc(track, DEVICE)
        v_cap = min(30.0, mpc.config.unlocalised_max_speed or 30.0)
        for name, ref in battery(HORIZON).items():
            key = f"{track}/{name}"
            state, _ = mpc.jitted_get_control(mpc.initial_state(), ref, v_cap)
            if bool(state.solved) != bool(golden[f"{key}/solved"]):
                raise RuntimeError(f"{key}: compiled step's solved flag differs from the fixture")
            if bool(state.solved):
                for field in ("projected_control", "cum_time"):
                    err = float(np.abs(getattr(state, field).cpu().numpy() - golden[f"{key}/{field}"]).max())
                    worst = max(worst, err)
    if not worst <= GOLDEN_TOL:
        raise RuntimeError(f"compiled golden battery: max abs err {worst} > {GOLDEN_TOL}")
    info["golden"] = {"windows": len(TRACKS) * len(battery(HORIZON)), "max_abs_err": worst, "tolerance": GOLDEN_TOL}

    # (c) a replay synchronises nothing; (d) a capture that reads the card raises
    mpc = ge.make_mpc("racing", DEVICE)
    args = (
        torch.as_tensor(ge.batch_sweep.mixed_refs(HORIZON, 1)[0], device=DEVICE),
        torch.full((), 28.0, device=DEVICE),
        torch.zeros((), dtype=torch.bool, device=DEVICE),
        torch.zeros((), device=DEVICE),
    )
    state, _ = mpc.jitted_get_control(mpc.initial_state(), *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, _ = mpc.jitted_get_control(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    probe = torch.ones(4, device=DEVICE)
    try:
        graph_loop.CapturedGraph(lambda x: [x * x.sum().item()], [probe], "a read")
    except RuntimeError as err:
        info["capture_with_a_read_raises"] = str(err).splitlines()[0][:160]
    else:
        raise RuntimeError("a capture that reads the card did not raise")
    if not bool(state.solved) or not torch.equal(probe + 1, torch.full((4,), 2.0, device=DEVICE)):
        raise RuntimeError("the card after the sync-free replays and the failed capture")

    # (e) the perceiver's graph against eager at the training camera
    cfg = loop.perception_config(precision="bf16")
    perc = Perceiver(cfg, device=DEVICE)
    centre, left, right, _ = loop.circuit()
    frames, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, COMPILED_FRAMES)
    frames = [torch.as_tensor(f, device=DEVICE) for f in frames]
    info["perceiver"] = ge.compare_frames(perc, frames)
    if not info["perceiver"]["bit_equal"]:
        raise RuntimeError(f"perceiver graphs differ from eager: {info['perceiver']['mismatches']}")
    # the segmenter compiled at construction, against the eager forward
    aot = TrackSegmenterAOT(cfg, device=DEVICE)
    for i, frame in enumerate(frames):
        if not all(torch.equal(a, b) for a, b in zip(aot.segment_drivable_area(frame), perc.segmenter._apply(frame))):
            raise RuntimeError(f"TrackSegmenterAOT differs from the eager forward on frame {i}")

    # (f) eager against captured, in turns on fixed cores
    info["timed"] = {
        "racing_step": ge.timed_steps("racing", COMPILED_TIMED, DEVICE),
        "mapping_step": ge.timed_steps("mapping", COMPILED_TIMED, DEVICE),
        "perceiver_frame": ge.timed_frames(perc, frames, COMPILED_TIMED),
    }
    info["launches"] = dict(launches)
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 17 compiled entries", info)
    return info


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn``: ``reps`` calls captured as one CUDA
    graph, replayed and timed by CUDA events (no launch gaps)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_cuda_ms(graph.replay, 5) / reps


def _attention_backends(perc, frame) -> dict:
    """Each backend of ``F.scaled_dot_product_attention`` at SegFormer-B2's
    four stages at 1280x736 in bf16 (queries, reduced keys, heads of 64):
    device ms a call in a captured graph, None where the backend refuses
    the shapes; each backend's sum over a frame's 16 blocks; and the
    perceiver's captured pipeline a frame (ms a replay, 20 in a row) with
    each backend pinned in turn."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from acmpc_tpu_torch.models import segformer as sf
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    cfg = sf.SegformerConfig()
    backends = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.MATH)
    h, w = 736 // 4, 1280 // 4
    out: dict = {}
    for i in range(4):
        if i:
            h, w = h // 2, w // 2
        r = cfg.sr_ratios[i]
        t, kv, heads = h * w, (h // r) * (w // r), cfg.num_attention_heads[i]
        g = torch.Generator(device=DEVICE).manual_seed(i)
        q = torch.randn(1, heads, t, 64, generator=g, device=DEVICE, dtype=torch.bfloat16)
        k = torch.randn(1, heads, kv, 64, generator=g, device=DEVICE, dtype=torch.bfloat16)
        v = torch.randn(1, heads, kv, 64, generator=g, device=DEVICE, dtype=torch.bfloat16)
        row = {"queries": t, "keys": kv, "heads": heads}
        for backend in backends:
            def call(backend=backend):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(q, k, v)

            try:
                row[backend.name] = _graph_ms(call)
            except RuntimeError as err:
                row[backend.name] = None
                row[f"{backend.name}_refused"] = str(err).splitlines()[0][:120]
        out[f"stage{i + 1}"] = row
    frame_ms = {}
    for b in backends:
        per = [out[f"stage{i + 1}"][b.name] for i in range(4)]
        frame_ms[b.name] = None if None in per else sum(d * ms for d, ms in zip(cfg.depths, per))
    out["frame_ms"] = frame_ms
    timed = {k: v for k, v in frame_ms.items() if v is not None}
    out["fastest"] = min(timed, key=timed.get)
    pinned = sf.ATTENTION_BACKENDS
    pipeline = {}
    try:
        for b in backends[:3]:
            sf.ATTENTION_BACKENDS = [b]
            other = Perceiver(perc.cfg, perc.segmenter.model.state_dict(), device=DEVICE)
            try:
                pipeline[b.name] = time_cuda_ms(lambda: other._raw_pipeline(frame), 20)
            except RuntimeError as err:
                pipeline[b.name] = str(err).splitlines()[0][:120]
    finally:
        sf.ATTENTION_BACKENDS = pinned
    out["pipeline_ms"] = pipeline
    return out


def phase_segformer() -> dict:
    """SegFormer-B2 as the perceiver's segmenter at 1280x736 bf16: the
    captured pipeline against eager (bit-equal), the logits against the
    plain reference and its float8 control, the attention backends, the
    frame's times, its kernels and its spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.models import segformer as sf
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
    from acmpc_tpu_torch.utils.monitor import MONITOR
    from perfbench.metrics._peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
    from perfbench.metrics._segformer_flops import segformer_flops
    from perfbench.metrics.segformer_attention_roofline import FRAGMENTS
    from perfbench.reference.segformer import SHAPE_KEYS, SegFormer, fit_classifier, random_state

    t_phase = time.perf_counter()
    limit = json.loads((ROOT / "perfbench" / "traffic" / "perceive_b1.json").read_text())["logit_gap_limit"]
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="segformer_b2",
                              model_path=None)
    shape = {k: getattr(sf.SegformerConfig(), k) for k in SHAPE_KEYS}
    centre, left, right, _ = loop.circuit()
    host, masks = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, SEGFORMER_FRAMES)
    frames = [torch.as_tensor(f, device=DEVICE) for f in host]
    variables = fit_classifier(random_state(SEGFORMER_SEED, shape), shape,
                               [jpeg_round_trip_reference(f) for f in frames[:2]], masks[:2], DEVICE)
    perc = Perceiver(cfg, variables, device=DEVICE, keep_logits=True)
    info: dict = {"torch": torch.__version__, "frame": [cfg.image_height, cfg.image_width]}

    # (a) the captured pipeline against eager, every output and the logits
    mismatches = []
    captured = []
    for i, frame in enumerate(frames):
        eager, graph = perc._run_pipeline(jpeg_round_trip_reference(frame)), perc._raw_pipeline(frame)
        pairs = {"drivable": (eager[0], graph[0]), "semantics": (eager[1], graph[1]),
                 "logits": (eager.logits, graph.logits), **{k: (eager[2][k], graph[2][k]) for k in TRACK_KEYS}}
        mismatches += [f"frame {i}: {k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
        captured.append(graph.logits)
    info["graph_vs_eager"] = {"frames": len(frames), "bit_equal": not mismatches, "mismatches": mismatches[:10]}
    if mismatches:
        raise RuntimeError(f"SegFormer's captured pipeline differs from eager: {mismatches[:10]}")

    # (b) the logits at stage 1's grid against the plain reference, and its
    # float8 control
    ref, low = SegFormer(variables, shape, DEVICE), SegFormer(variables, shape, DEVICE, fp8=True)
    gaps, controls, drivable = [], [], []
    for frame, got in zip(frames, captured):
        image = jpeg_round_trip_reference(frame)
        want = ref.coarse_logits(image)
        scale = want.abs().max().double()
        gaps.append(float((got[0].permute(2, 0, 1).double() - want.double()).abs().max() / scale))
        controls.append(float((low.coarse_logits(image).double() - want.double()).abs().max() / scale))
        drivable.append(float((torch.argmax(want, dim=0) == 1).float().mean()))
    info["reference"] = {"logit_gap": gaps, "fp8_logit_gap": controls, "limit": limit,
                         "drivable_share": drivable}
    if not max(gaps) <= limit or not min(controls) > limit:
        raise RuntimeError(f"SegFormer against the reference: {info['reference']}")

    # (c) the attention backends at the four stages' shapes
    info["attention_backends"] = _attention_backends(perc, frames[0])
    info["pinned"] = [b.name for b in sf.ATTENTION_BACKENDS]

    # (d) a frame's times: perceive (host frame in, tracks to the host), the
    # captured pipeline, the segmenter alone eager
    def perceive(i=[0]):
        i[0] += 1
        out = perc.perceive(host[i[0] % len(host)])
        return [out[k].cpu() for k in ("left", "right", "centreline")]

    walls = []
    for _ in range(SEGFORMER_TIMED):
        t0 = time.perf_counter()
        perceive()
        walls.append(1e3 * (time.perf_counter() - t0))
    info["perceive_ms"] = {"p50": float(np.percentile(walls, 50)), "p95": float(np.percentile(walls, 95))}
    info["captured_pipeline_ms"] = time_cuda_ms(lambda: perc._raw_pipeline(frames[0]), SEGFORMER_TIMED)
    info["segmenter_eager_ms"] = time_cuda_ms(lambda: perc.segmenter._apply(frames[0]), SEGFORMER_TIMED)

    # (e) the kernels of captured frames, by device time a frame
    n_prof = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            perc._raw_pipeline(frames[0])
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            row = table.setdefault(evt.name, [0.0, 0])
            row[0] += (evt.time_range.end - evt.time_range.start) * 1e-3 / n_prof
            row[1] += 1
    top = sorted(table.items(), key=lambda kv: -kv[1][0])
    info["kernels_per_frame"] = [[name[:140], ms, n // n_prof] for name, (ms, n) in top[:16]]
    info["device_ms_per_frame"] = sum(ms for ms, _ in table.values())
    att = [(name, row) for name, row in table.items() if any(f in name for f in FRAGMENTS)]
    work = segformer_flops(cfg.image_height, cfg.image_width, {**shape, "num_channels": 3})
    least_ms = 1e3 * max(work["attention"] / BF16_FLOP_PER_S, work["attention_bytes"] / HBM_BYTES_PER_S)
    att_ms = sum(row[0] for _, row in att)
    info["attention"] = {
        "kernels": sorted({name[:140] for name, _ in att}), "launches_per_frame": sum(r[1] for _, r in att) // n_prof,
        "ms_per_frame": att_ms, "least_ms": least_ms, "roofline_pct": 100.0 * least_ms / att_ms if att_ms else None,
        "gflop": work["attention"] / 1e9,
    }
    if not att:
        raise RuntimeError(f"no attention kernel matches {FRAGMENTS}: {list(table)[:20]}")
    info["frame_gflop"] = work["total"] / 1e9
    info["mfu_pct_captured"] = 100.0 * work["total"] / BF16_FLOP_PER_S / (info["captured_pipeline_ms"] * 1e-3)

    # (f) the spans and the counter, with the monitor on (a graph of its own)
    MONITOR.enable()
    try:
        MONITOR.clear()
        for i in range(3):
            perc.perceive(host[i])
        torch.cuda.synchronize()
        for i in range(3):
            perc.perceive(host[i])
        torch.cuda.synchronize()
        taken = MONITOR.take()
    finally:
        MONITOR.disable()
        MONITOR.clear()
    samples = collections.Counter(name for name, _, _ in taken["device"])
    want_spans = [f"segformer.stage{i}" for i in range(1, 5)] + ["segformer.decode", "segformer.attention"]
    info["spans"] = {"samples": {k: samples[k] for k in want_spans + ["perceiver.segment"]},
                     "counter": taken["counters"].get("segmenter.forward:segformer_b2", 0)}
    if taken["counters"].get("segmenter.forward:segformer_b2") != 6 or not all(samples[k] for k in want_spans):
        raise RuntimeError(f"SegFormer's spans or counter: {info['spans']}, {dict(taken['counters'])}")
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 18 segformer", info)
    return info


def _masked_attention_backends() -> dict:
    """Each backend of ``F.scaled_dot_product_attention`` at Mask2Former's
    masked cross-attention (100 queries, 8 heads of 32, a boolean mask
    broadcast over the heads) at the three key lengths at 1280x736 in
    bf16: device ms a call in a captured graph, None where the backend
    refuses the mask; each backend's sum over a frame's 9 layers."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                SDPBackend.MATH)
    out: dict = {}
    for keys in (920, 3680, 14720):
        g = torch.Generator(device=DEVICE).manual_seed(keys)
        q = torch.randn(1, 8, 100, 32, generator=g, device=DEVICE, dtype=torch.bfloat16)
        k = torch.randn(1, 8, keys, 32, generator=g, device=DEVICE, dtype=torch.bfloat16)
        v = torch.randn(1, 8, keys, 32, generator=g, device=DEVICE, dtype=torch.bfloat16)
        mask = torch.rand(1, 1, 100, keys, generator=g, device=DEVICE) < 0.5
        mask[..., :1] = True
        row = {}
        for backend in backends:
            def call(backend=backend):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

            try:
                row[backend.name] = _graph_ms(call)
            except RuntimeError as err:
                row[backend.name] = None
                row[f"{backend.name}_refused"] = str(err).splitlines()[0][:120]
        out[f"keys{keys}"] = row
    frame_ms = {}
    for b in backends:
        per = [out[f"keys{n}"][b.name] for n in (920, 3680, 14720)]
        frame_ms[b.name] = None if None in per else 3 * sum(per)
    out["frame_ms"] = frame_ms
    timed = {k: v for k, v in frame_ms.items() if v is not None}
    out["fastest"] = min(timed, key=timed.get)
    return out


def _deform_kernel() -> dict:
    """``ms_deform_attn`` against its plain version at the published shapes
    (19,320 queries over 23x40, 46x80 and 92x160, 8 heads of 32, 4
    points; offsets of a few cells, some whole, some far outside the
    map): the worst difference; ms a launch (CUDA events), the plain
    version's, the grid_sample composition's (Deformable DETR's, the
    library's yardstick), and the bound (bytes at the HBM peak, or the
    sampling's operations at the fp32 peak)."""
    import torch
    import torch.nn.functional as F

    from acmpc_tpu_torch.ops import ms_deform_attn as op
    from perfbench.metrics._peaks import FP32_FLOP_PER_S

    shapes = [(23, 40), (46, 80), (92, 160)]
    S = sum(h * w for h, w in shapes)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    value = torch.randn(1, S, 256, device=DEVICE, generator=g).bfloat16()
    offsets = torch.randn(1, S, 192, device=DEVICE, generator=g) * 3
    offsets[0, ::7, ::3] = torch.round(offsets[0, ::7, ::3])
    offsets[0, ::11, ::5] *= 40
    offsets = offsets.bfloat16()
    logits = torch.randn(1, S, 96, device=DEVICE, generator=g).bfloat16()
    got = op.ms_deform_attn(value, offsets, logits, shapes).float()
    want = op.ms_deform_attn_reference(value, offsets, logits, shapes).float()
    torch.cuda.synchronize()
    gap = (got - want).abs()
    allowed = DEFORM_RTOL * torch.maximum(got.abs(), want.abs()) + DEFORM_ATOL_SHARE * want.abs().max()
    if not bool((gap <= allowed).all()):
        raise RuntimeError(f"ms_deform_attn differs from its plain version: {float(gap.max())}")

    def composed():
        M, D, L, P = 8, 32, 3, 4
        loc = op.sampling_locations(offsets.view(1, S, M, L, P, 2), shapes)
        w = torch.softmax(logits.view(1, S, M, L * P).float(), -1).view(M, S, L * P)
        values = value.view(1, S, M, D).split([h * w_ for h, w_ in shapes], dim=1)
        sampled = [F.grid_sample(v.flatten(2).transpose(1, 2).reshape(M, D, h, w_),
                                 (2 * loc[:, :, :, l] - 1).transpose(1, 2).flatten(0, 1).bfloat16(),
                                 mode="bilinear", padding_mode="zeros", align_corners=False)
                   for l, (v, (h, w_)) in enumerate(zip(values, shapes))]
        return (torch.stack(sampled, dim=-2).flatten(-2) * w[:, None].bfloat16()).sum(-1)

    work_bytes = 2.0 * S * (256 + 192 + 96 + 256)
    work_ops = S * 8 * 12 * 32 * 9.0
    bound_ms = 1e3 * max(work_bytes / HBM_BYTES_PER_S, work_ops / FP32_FLOP_PER_S)
    return {
        "queries": S, "max_abs_err": float(gap.max()), "max_rel_err": float(gap.max() / want.abs().max()),
        "ms": time_cuda_ms(lambda: op.ms_deform_attn(value, offsets, logits, shapes), 50),
        "plain_ms": time_cuda_ms(lambda: op.ms_deform_attn_reference(value, offsets, logits, shapes), 5),
        "library_ms": time_cuda_ms(composed, 20),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if work_bytes / HBM_BYTES_PER_S >= work_ops / FP32_FLOP_PER_S else "operations",
    }


def phase_mask2former() -> dict:
    """Mask2Former-R50 as the perceiver's segmenter at 1280x736 bf16: the
    deformable sampling kernel against its plain version, the captured
    pipeline against eager (bit-equal) and its six launches a frame, the
    logits against the plain reference fed the program's masks and its
    float8 control, the masked attention's backends, the frame's times,
    its kernels and its spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.models import mask2former as m2f
    from acmpc_tpu_torch.ops import ms_deform_attn as op
    from acmpc_tpu_torch.ops.graph_loop import settle_launches
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
    from acmpc_tpu_torch.utils.monitor import MONITOR
    from perfbench.drivers.perceive import asphalt
    from perfbench.metrics._mask2former_flops import mask2former_flops
    from perfbench.metrics._peaks import BF16_FLOP_PER_S, FP32_FLOP_PER_S
    from perfbench.reference.mask2former import Mask2Former, fit_heads, random_state

    t_phase = time.perf_counter()
    limits = json.loads((ROOT / "perfbench" / "traffic" / "perceive_m2f_b1.json").read_text())
    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_r50.json").read_text())
    info: dict = {"torch": torch.__version__, "kernel": _deform_kernel()}
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="mask2former_r50",
                              model_path=None)
    centre, left, right, _ = loop.circuit()
    host, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, MASK2FORMER_FRAMES)
    frames = [torch.as_tensor(f, device=DEVICE) for f in host]
    fit = [jpeg_round_trip_reference(f).cpu().numpy() for f in frames[:2]]
    variables = fit_heads(random_state(MASK2FORMER_SEED, shape), shape, fit, [asphalt(i) for i in fit], DEVICE)
    perc = Perceiver(cfg, variables, device=DEVICE, keep_logits=True)
    info["frame"] = [cfg.image_height, cfg.image_width]

    # (a) the captured pipeline against eager, every output and the logits;
    # the kernel's launches a frame
    mismatches, captured = [], []
    for i, frame in enumerate(frames):
        eager, graph = perc._run_pipeline(jpeg_round_trip_reference(frame)), perc._raw_pipeline(frame)
        pairs = {"drivable": (eager[0], graph[0]), "semantics": (eager[1], graph[1]),
                 **{f"logits{j}": ab for j, ab in enumerate(zip(eager.logits, graph.logits))},
                 **{k: (eager[2][k], graph[2][k]) for k in TRACK_KEYS}}
        mismatches += [f"frame {i}: {k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
        captured.append(graph.logits)
    info["graph_vs_eager"] = {"frames": len(frames), "bit_equal": not mismatches, "mismatches": mismatches[:10]}
    if mismatches:
        raise RuntimeError(f"Mask2Former's captured pipeline differs from eager: {mismatches[:10]}")
    settle_launches()
    op.ms_deform_attn.launches.clear()
    for frame in frames:
        perc._raw_pipeline(frame)
    settle_launches()
    info["launches_per_frame"] = op.ms_deform_attn.launches[op.KERNEL] / len(frames)
    if info["launches_per_frame"] != 6:
        raise RuntimeError(f"ms_deform_attn launches a frame: {info['launches_per_frame']}")

    # (b) the logits against the plain reference fed the program's masks,
    # and its float8 control
    ref, low = Mask2Former(variables, shape, DEVICE), Mask2Former(variables, shape, DEVICE, fp8=True)

    def gap(got, want):
        return float((got.double() - want.double()).abs().max() / want.abs().max())

    gaps: dict = {k: [] for k in ("class", "mask", "encoder", "fp8_class", "fp8_mask", "fp8_encoder")}
    released = []
    for frame, (cls, mask, memory, *masks) in zip(frames, captured):
        image = jpeg_round_trip_reference(frame)
        forced = [m[0] for m in masks]
        want, lw = ref.forward(image, forced), low.forward(image, forced)
        for name, key, got in (("class", "class_logits", cls[0]), ("mask", "mask_logits", mask[0]),
                               ("encoder", "memory", memory[0])):
            gaps[name].append(gap(got, want[key]))
            gaps[f"fp8_{name}"].append(gap(lw[key], want[key]))
        released.append(sum(int(m.all(-1).sum()) for m in masks))
    info["reference"] = {"gaps": gaps, "limits": {k: limits[f"{k}_gap_limit" if k != "mask" else "mask_logit_gap_limit"]
                                                  for k in ("class", "mask", "encoder")},
                         "released_rows": released}
    sound = all(max(gaps[k]) <= info["reference"]["limits"][k] for k in ("class", "mask", "encoder"))
    control = any(min(gaps[f"fp8_{k}"]) > info["reference"]["limits"][k] for k in ("class", "mask", "encoder"))
    if not sound or not control:
        raise RuntimeError(f"Mask2Former against the reference: {info['reference']}")

    # (c) the masked attention's backends at the three key lengths
    info["attention_backends"] = _masked_attention_backends()
    info["pinned"] = [b.name for b in m2f.ATTENTION_BACKENDS]

    # (d) a frame's times: perceive (host frame in, tracks to the host), the
    # captured pipeline, the segmenter alone eager
    def perceive(i=[0]):
        i[0] += 1
        out = perc.perceive(host[i[0] % len(host)])
        return [out[k].cpu() for k in ("left", "right", "centreline")]

    walls = []
    for _ in range(MASK2FORMER_TIMED):
        t0 = time.perf_counter()
        perceive()
        walls.append(1e3 * (time.perf_counter() - t0))
    info["perceive_ms"] = {"p50": float(np.percentile(walls, 50)), "p95": float(np.percentile(walls, 95))}
    info["captured_pipeline_ms"] = time_cuda_ms(lambda: perc._raw_pipeline(frames[0]), MASK2FORMER_TIMED)
    info["segmenter_eager_ms"] = time_cuda_ms(lambda: perc.segmenter._apply(frames[0]), 10)

    # (e) the kernels of captured frames, by device time a frame
    n_prof = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            perc._raw_pipeline(frames[0])
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            row = table.setdefault(evt.name, [0.0, 0])
            row[0] += (evt.time_range.end - evt.time_range.start) * 1e-3 / n_prof
            row[1] += 1
    top = sorted(table.items(), key=lambda kv: -kv[1][0])
    info["kernels_per_frame"] = [[name[:140], ms, n // n_prof] for name, (ms, n) in top[:16]]
    info["device_ms_per_frame"] = sum(ms for ms, _ in table.values())
    work = mask2former_flops(cfg.image_height, cfg.image_width, shape)
    deform = [(name, row) for name, row in table.items() if op.KERNEL in name]
    deform_ms = sum(row[0] for _, row in deform)
    least_ms = 1e3 * max(work["sampling"] / FP32_FLOP_PER_S, work["sampling_bytes"] / HBM_BYTES_PER_S)
    info["deform_attn"] = {"ms_per_frame": deform_ms, "launches_per_frame": sum(r[1] for _, r in deform) // n_prof,
                           "least_ms": least_ms, "roofline_pct": 100.0 * least_ms / deform_ms if deform_ms else None}
    if not deform:
        raise RuntimeError(f"no kernel named {op.KERNEL} ran: {list(table)[:20]}")
    info["frame_gflop"] = work["total"] / 1e9
    info["mfu_pct_captured"] = 100.0 * work["total"] / BF16_FLOP_PER_S / (info["captured_pipeline_ms"] * 1e-3)

    # (f) the spans and the counter, with the monitor on (a graph of its own)
    MONITOR.enable()
    try:
        MONITOR.clear()
        for i in range(3):
            perc.perceive(host[i])
        torch.cuda.synchronize()
        for i in range(3):
            perc.perceive(host[i])
        torch.cuda.synchronize()
        taken = MONITOR.take()
    finally:
        MONITOR.disable()
        MONITOR.clear()
    samples = collections.Counter(name for name, _, _ in taken["device"])
    want_spans = ["mask2former.backbone", "mask2former.pixel_decoder", "mask2former.deform_attn",
                  "mask2former.decoder", "mask2former.masked_attention", "mask2former.semantic"]
    graph = "Perceiver._run_raw_frame"
    info["spans"] = {"samples": {k: samples[k] for k in want_spans + ["perceiver.segment"]},
                     "counter": taken["counters"].get("segmenter.forward:mask2former_r50", 0),
                     # one replay a frame; the one capture is the monitor's own graph, at its first frame
                     "replays": taken["counters"].get(f"graph.replay:{graph}", 0),
                     "captures": taken["counters"].get(f"graph.capture:{graph}", 0)}
    if (taken["counters"].get("segmenter.forward:mask2former_r50") != 6 or not all(samples[k] for k in want_spans)
            or info["spans"]["replays"] != 6 or info["spans"]["captures"] != 1):
        raise RuntimeError(f"Mask2Former's spans or counter: {info['spans']}, {dict(taken['counters'])}")
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 19 mask2former", info)
    return info


def _window_kernel() -> dict:
    """``window_attention`` at Swin-L's four stage shapes (window 12,
    unshifted and shifted by 6; qkv of N(0, 2^2), bias and table N(0,
    1)): against the exact attention (float64 of the same inputs) no
    further than the plain bf16 composition, up to one rounding of the
    output (``tests/test_torch_cuda.py``); ms a launch (CUDA events),
    the plain version's, the library's yardstick (SDPA on the windows
    partitioned beforehand, the bias and mask added into one float mask
    beforehand: its call alone) and the bound (bytes at the HBM peak or
    Q K^T and P V at the bf16 peak); and a frame's 24 blocks summed."""
    import torch
    import torch.nn.functional as F

    from acmpc_tpu_torch.ops import window_attention as op
    from perfbench.metrics._peaks import BF16_FLOP_PER_S

    rows, frame = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (h, w), c, heads, blocks in SWIN_L_STAGES:
        for shift in (0, 6):
            g = torch.Generator(device=DEVICE).manual_seed(5)
            qkv = (2.0 * torch.randn((1, h, w, 3 * c), device=DEVICE, generator=g)).bfloat16()
            bias = torch.randn(3 * c, device=DEVICE, generator=g).bfloat16()
            table = torch.randn((23 * 23, heads), device=DEVICE, generator=g).bfloat16()
            got = op.window_attention(qkv, bias, table, heads, 12, shift).double()
            want = op.window_attention_reference(qkv, bias, table, heads, 12, shift).double()
            exact = op.window_attention_reference(qkv.double(), bias.double(), table.double(), heads, 12, shift)
            err, plain_err = float((got - exact).abs().max()), float((want - exact).abs().max())
            if err > plain_err + 2.0 ** -8 * float(exact.abs().max()):
                raise RuntimeError(f"window_attention at {h}x{w}, shift {shift}: {err} against the plain {plain_err}")
            # the yardstick's inputs: the windows and one float bias + mask
            hp, wp = -(-h // 12) * 12, -(-w // 12) * 12
            x = bias.expand(1, hp, wp, 3 * c).clone()
            x[:, :h, :w] = qkv
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
            q, k, v = op.partition(x, 12).view(-1, 144, 3, heads, 32).permute(2, 0, 3, 1, 4).contiguous()
            rel = table[op.relative_position_index(12, DEVICE).view(-1)].view(144, 144, heads).permute(2, 0, 1)
            mask = rel[None] + (op.shift_mask(hp, wp, 12, shift, DEVICE)[:, None].bfloat16() if shift else 0)
            mask = mask.expand(q.shape[0], heads, 144, 144).contiguous()
            work_bytes, work_ops = 2.0 * h * w * 4 * c, 2.0 * 2 * h * w * 144 * c
            row = {
                "grid": [h, w], "channels": c, "heads": heads, "shift": shift, "max_abs_err": err,
                "plain_max_abs_err": plain_err,
                "ms": time_cuda_ms(lambda: op.window_attention(qkv, bias, table, heads, 12, shift), 50),
                "plain_ms": time_cuda_ms(lambda: op.window_attention_reference(qkv, bias, table, heads, 12, shift), 5),
                "library_ms": time_cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20),
                "bound_ms": 1e3 * max(work_bytes / HBM_BYTES_PER_S, work_ops / BF16_FLOP_PER_S),
                "bound_by": "bytes" if work_bytes / HBM_BYTES_PER_S >= work_ops / BF16_FLOP_PER_S else "operations",
            }
            rows.append(row)
            for key in frame:
                frame[key] += blocks / 2 * row[key]
    return {"stages": rows, "frame": frame}


def phase_swin() -> dict:
    """Mask2Former-Swin-L as the perceiver's segmenter at 1280x736 bf16:
    the window-attention kernel alone at the four stages' shapes, the
    captured pipeline against eager and its launches a frame, the gaps
    against the plain reference and its float8 control, the frame's
    times, its kernels and its spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.ops import ms_deform_attn as deform
    from acmpc_tpu_torch.ops import window_attention as op
    from acmpc_tpu_torch.ops.graph_loop import settle_launches
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
    from acmpc_tpu_torch.utils.monitor import MONITOR
    from perfbench.drivers.perceive import asphalt
    from perfbench.metrics._peaks import BF16_FLOP_PER_S
    from perfbench.metrics._swin_flops import swin_flops
    from perfbench.reference.swin import Mask2Former, fit_heads, random_state

    t_phase = time.perf_counter()
    limits = json.loads((ROOT / "perfbench" / "traffic" / "perceive_swin_b1.json").read_text())
    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_swin_l.json").read_text())
    info: dict = {"torch": torch.__version__, "kernel": _window_kernel()}
    emit("phase 21 swin kernel", info["kernel"])
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="mask2former_swin_l",
                              model_path=None)
    centre, left, right, _ = loop.circuit()
    host, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, SWIN_FRAMES)
    frames = [torch.as_tensor(f, device=DEVICE) for f in host]
    fit = [jpeg_round_trip_reference(f).cpu().numpy() for f in frames[:2]]
    variables = fit_heads(random_state(SWIN_SEED, shape), shape, fit, [asphalt(i) for i in fit], DEVICE)
    perc = Perceiver(cfg, variables, device=DEVICE, keep_logits=True)

    # (a) the captured pipeline against eager; the kernels' launches a frame
    mismatches, captured = [], []
    for i, frame in enumerate(frames):
        eager, graph = perc._run_pipeline(jpeg_round_trip_reference(frame)), perc._raw_pipeline(frame)
        pairs = {"drivable": (eager[0], graph[0]), "semantics": (eager[1], graph[1]),
                 **{f"logits{j}": ab for j, ab in enumerate(zip(eager.logits, graph.logits))},
                 **{k: (eager[2][k], graph[2][k]) for k in TRACK_KEYS}}
        mismatches += [f"frame {i}: {k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
        captured.append(graph.logits)
    info["graph_vs_eager"] = {"frames": len(frames), "bit_equal": not mismatches, "mismatches": mismatches[:10]}
    if mismatches:
        raise RuntimeError(f"Mask2Former-Swin-L's captured pipeline differs from eager: {mismatches[:10]}")
    settle_launches()
    op.window_attention.launches.clear()
    deform.ms_deform_attn.launches.clear()
    for frame in frames:
        perc._raw_pipeline(frame)
    settle_launches()
    info["launches_per_frame"] = {"window_attention": op.window_attention.launches[op.KERNEL] / len(frames),
                                  "ms_deform_attn": deform.ms_deform_attn.launches[deform.KERNEL] / len(frames)}
    if info["launches_per_frame"] != {"window_attention": 24, "ms_deform_attn": 6}:
        raise RuntimeError(f"Mask2Former-Swin-L's launches a frame: {info['launches_per_frame']}")

    # (b) against the plain reference fed the program's masks, and its
    # float8 control
    ref, low = Mask2Former(variables, shape, DEVICE), Mask2Former(variables, shape, DEVICE, fp8=True)

    def gap(got, want):
        return float((got.double() - want.double()).abs().max() / want.abs().max())

    names = ("class", "mask_logit", "encoder", "backbone")
    gaps: dict = {k: [] for k in names + tuple(f"fp8_{n}" for n in names)}
    for frame, (cls, mask, memory, *rest) in zip(frames, captured):
        masks, feats = [m[0] for m in rest[:-4]], rest[-4:]
        image = jpeg_round_trip_reference(frame)
        want, lw = ref.forward(image, masks), low.forward(image, masks)
        for name, key, got in (("class", "class_logits", cls[0]), ("mask_logit", "mask_logits", mask[0]),
                               ("encoder", "memory", memory[0])):
            gaps[name].append(gap(got, want[key]))
            gaps[f"fp8_{name}"].append(gap(lw[key], want[key]))
        maps, low_maps = ref.backbone_maps(image), low.backbone_maps(image)
        gaps["backbone"].append(max(gap(f[0], m) for f, m in zip(feats, maps)))
        gaps["fp8_backbone"].append(max(gap(a, m) for a, m in zip(low_maps, maps)))
    info["reference"] = {"gaps": gaps, "limits": {k: limits[f"{k}_gap_limit"] for k in names}}
    sound = all(max(gaps[k]) <= limits[f"{k}_gap_limit"] for k in names)
    control = any(min(gaps[f"fp8_{k}"]) > limits[f"{k}_gap_limit"] for k in names)
    emit("phase 21 swin reference", info["reference"])
    if not sound or not control:
        raise RuntimeError(f"Mask2Former-Swin-L against the reference: {info['reference']}")

    # (c) a frame's times: perceive (host frame in, tracks to the host), the
    # captured pipeline
    def perceive(i=[0]):
        i[0] += 1
        out = perc.perceive(host[i[0] % len(host)])
        return [out[k].cpu() for k in ("left", "right", "centreline")]

    walls = []
    for _ in range(SWIN_TIMED):
        t0 = time.perf_counter()
        perceive()
        walls.append(1e3 * (time.perf_counter() - t0))
    info["perceive_ms"] = {"p50": float(np.percentile(walls, 50)), "p95": float(np.percentile(walls, 95))}
    info["captured_pipeline_ms"] = time_cuda_ms(lambda: perc._raw_pipeline(frames[0]), SWIN_TIMED)

    # (d) the kernels of captured frames, by device time a frame
    n_prof = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            perc._raw_pipeline(frames[0])
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            row = table.setdefault(evt.name, [0.0, 0])
            row[0] += (evt.time_range.end - evt.time_range.start) * 1e-3 / n_prof
            row[1] += 1
    top = sorted(table.items(), key=lambda kv: -kv[1][0])
    info["kernels_per_frame"] = [[name[:140], ms, n // n_prof] for name, (ms, n) in top[:20]]
    info["device_ms_per_frame"] = sum(ms for ms, _ in table.values())
    work = swin_flops(cfg.image_height, cfg.image_width, shape)
    window_ms = sum(row[0] for name, row in table.items() if op.KERNEL in name)
    least_ms = 1e3 * max(work["attention"] / BF16_FLOP_PER_S, work["attention_bytes"] / HBM_BYTES_PER_S)
    info["window_attention"] = {"ms_per_frame": window_ms, "least_ms": least_ms,
                                "roofline_pct": 100.0 * least_ms / window_ms if window_ms else None}
    if not window_ms:
        raise RuntimeError(f"no kernel named {op.KERNEL} ran: {list(table)[:20]}")
    info["frame_gflop"] = work["total"] / 1e9
    info["mfu_pct_captured"] = 100.0 * work["total"] / BF16_FLOP_PER_S / (info["captured_pipeline_ms"] * 1e-3)

    # (e) the spans, with the monitor on (a graph of its own)
    MONITOR.enable()
    try:
        for i in range(3):  # the monitor's own capture, then replays
            perc.perceive(host[i])
        torch.cuda.synchronize()
        MONITOR.clear()
        for i in range(3):
            perc.perceive(host[i])
        torch.cuda.synchronize()
        taken = MONITOR.take()
    finally:
        MONITOR.disable()
        MONITOR.clear()
    samples = collections.Counter(name for name, _, _ in taken["device"])
    device_ms: dict = collections.defaultdict(float)
    for name, _, ms in taken["device"]:
        device_ms[name] += ms / max(samples["swin.stage1"], 1)
    want_spans = ["mask2former.backbone", *(f"swin.stage{i}" for i in range(1, 5)), "swin.window_attention"]
    info["spans"] = {"samples": {k: samples[k] for k in want_spans},
                     "device_ms_per_frame": {k: device_ms[k] for k in want_spans + ["perceiver.segment"]}}
    if samples["swin.window_attention"] != 24 * samples["swin.stage1"] or not all(samples[k] for k in want_spans):
        raise RuntimeError(f"Mask2Former-Swin-L's spans: {info['spans']}")
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 21 swin", info)
    return info


def phase_segformer_resample() -> dict:
    """SegFormer's head resample: the kernel against its plain version at
    both frames, both batches and both dtypes; its times; in the SegFormer
    perceiver, the captured replays and the plain head against eager, the
    launches a frame and a profile (see the module's phase 20)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.bench import segformer_head as head
    from acmpc_tpu_torch.models import segformer as sf
    from acmpc_tpu_torch.ops import segformer_resample as op
    from acmpc_tpu_torch.ops.graph_loop import settle_launches
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS
    from perfbench.reference.segformer import SHAPE_KEYS, random_state

    t_phase = time.perf_counter()
    info: dict = {"torch": torch.__version__}

    # (a) the kernel against the plain version
    rows = []
    for frame in RESAMPLE_FRAMES:
        for n in (1, 2):
            for dtype in (torch.bfloat16, torch.float32):
                parts = head.head_parts(n, *frame, dtype, DEVICE, seed=n)
                size = parts[0].shape[-2:]
                got = op.segformer_resample(parts, size)
                want = op.segformer_resample_reference(parts, size)
                rows.append({"frame": list(frame), "n": n, "dtype": str(dtype).removeprefix("torch."),
                             **head.compare(got, want), "strides_equal": got.stride() == want.stride()})
                del parts, got, want
    info["kernel_vs_plain"] = rows
    if any(r["max_ulps"] > 1 or not r["strides_equal"] for r in rows):
        raise RuntimeError(f"segformer_resample against its plain version: {rows}")

    # (b) its time at the cell's shape, beside the plain version's and the bound
    info["timed"] = head.measure(1, *RESAMPLE_FRAMES[0], torch.bfloat16, DEVICE)

    # (c) the perceiver: captured replays and the plain head against eager,
    # one launch a frame
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="segformer_b2",
                              model_path=None)
    shape = {k: getattr(sf.SegformerConfig(), k) for k in SHAPE_KEYS}
    centre, left, right, _ = loop.circuit()
    host, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, RESAMPLE_PERCEIVER_FRAMES)
    frames = [torch.as_tensor(f, device=DEVICE) for f in host]
    perc = Perceiver(cfg, random_state(SEGFORMER_SEED, shape), device=DEVICE, keep_logits=True)
    mismatches = []
    for i, frame in enumerate(frames):
        image = jpeg_round_trip_reference(frame)
        eager, graph = perc._run_pipeline(image), perc._raw_pipeline(frame)
        pinned, sf.segformer_resample = sf.segformer_resample, op.segformer_resample_reference
        try:
            plain = perc._run_pipeline(image)
        finally:
            sf.segformer_resample = pinned
        for name, other in (("graph", graph), ("plain_head", plain)):
            pairs = {"logits": (eager.logits, other.logits), "drivable": (eager[0], other[0]),
                     "semantics": (eager[1], other[1]), **{k: (eager[2][k], other[2][k]) for k in TRACK_KEYS}}
            mismatches += [f"frame {i} {name}: {k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    info["bit_equal"] = {"frames": len(frames), "mismatches": mismatches[:10]}
    if mismatches:
        raise RuntimeError(f"SegFormer through the resample kernel differs: {mismatches[:10]}")
    settle_launches()
    op.segformer_resample.launches.clear()
    for frame in frames:
        perc._raw_pipeline(frame)
    settle_launches()
    info["launches_per_frame"] = op.segformer_resample.launches[op.KERNEL] / len(frames)
    if info["launches_per_frame"] != 1:
        raise RuntimeError(f"segformer_resample launches a frame: {info['launches_per_frame']}")

    # (d) the kernels of captured frames, by device time a frame
    n_prof = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            perc._raw_pipeline(frames[0])
        torch.cuda.synchronize()
    table: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            row = table.setdefault(evt.name, [0.0, 0])
            row[0] += (evt.time_range.end - evt.time_range.start) * 1e-3 / n_prof
            row[1] += 1
    top = sorted(table.items(), key=lambda kv: -kv[1][0])
    info["kernels_per_frame"] = [[name[:140], ms, n // n_prof] for name, (ms, n) in top[:12]]
    info["device_ms_per_frame"] = sum(ms for ms, _ in table.values())
    info["resample_ms_per_frame"] = sum(ms for name, (ms, _) in table.items() if op.KERNEL in name)
    info["captured_pipeline_ms"] = time_cuda_ms(lambda: perc._raw_pipeline(frames[0]), SEGFORMER_TIMED)
    info["phase_s"] = time.perf_counter() - t_phase
    info["card"] = card_line()
    emit("phase 20 segformer resample", info)
    return info


def kernels_line(
    kernel: dict, main: dict, mapping: dict, sweep: dict, multi: dict, perception: dict, agent: dict,
    tools: dict, parallel: dict, vmapped: dict, training: dict, compiled: dict, segformer: dict,
    mask2former: dict, resample: dict, swin: dict,
) -> dict:
    """One row per kernel variant: launches summed over the paths
    (phases 4, 6, 8-10 and 12-17; phase 5 and 7 are single-scenario
    checks; a replayed graph counts the kernels captured in it, its loop
    bodies' once a trip), each counted by its own name: the box-block cluster kernel
    takes every control QP and the racelines up to 942 points, the
    box-block split kernel the 1,953-point raceline (no path masks it);
    the dense cluster kernel phase 15's random QPs; the dense split
    kernel no path (no caller hands it a dense operator that no cluster
    holds); chain edges phase 10's loop, phase 12 and 13's racing agent
    and 16's loop; the graph loop's condition kernel phases 12, 13 and 17 (once
    a replay of a step, once a chunk); the JPEG round trip's two kernels
    phase 10's ``perceive`` and 12 and 13's racing agent, a frame each
    (a max_abs_err of 0: byte-equal to the plain version and OpenCV, or
    the phase raised; the bound the frame read once by the blocks kernel
    and written once by the colour kernel; ms under the profiler on a
    simulator frame). Numbers from phase 3 (dense:
    horizon 50 at B = 256, the
    mapping shapes for the split kernel; box block:
    horizon 50 at B = 256 for the cluster kernel, the 1,953-point
    raceline for the split kernel, with the bound of what those inputs
    need) and for the chain-edges kernel from phase 10 at 1280x736, band 4."""
    import acmpc_tpu_torch.ops.admm_chunk as ops
    import acmpc_tpu_torch.ops.jpeg_round_trip as jpeg
    import acmpc_tpu_torch.ops.ruiz as ruiz
    import acmpc_tpu_torch.ops.track_chain as chain

    import acmpc_tpu_torch.ops.graph_loop as graph_loop

    paths = collections.Counter()
    for path in (main, mapping, sweep, multi, perception, agent, tools, parallel, vmapped, training, compiled):
        paths.update(path["launches"])

    def row(name, key, line, prefix=""):
        r = kernel[key]
        variant = name.removeprefix("admm_chunk_").split("[")[0]
        return {
            "name": name,
            "route": "cuda",
            "source": f"acmpc_tpu_torch/csrc/{ops.SOURCES[variant]}",
            "replaces": f"acmpc_tpu/ops/pallas_admm.py:{line}",
            "launches": paths.get(name, 0),
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
    edges = perception["chain_edges"]["band4"]
    sim_jpeg = perception["jpeg_round_trip"]["sim"]
    return {
        "kernels": [
            row(ops.CLUSTER, h50, 99),
            row(ops.CLUSTER_ACTIVE, h50a, 103),
            row(ops.CLUSTER_BOX, f"box_{h50}", 99),
            row(ops.CLUSTER_BOX_ACTIVE, f"box_{h50a}", 103),
            row(ops.SPLIT, h100, 99),
            row(ops.SPLIT_ACTIVE, h100a, 103),
            row(ops.SPLIT_BOX, "box_n1953_B1", 99),
            row(ops.SPLIT_BOX_ACTIVE, "box_n1953_B1_active", 103),
            {
                "name": chain.TRACK_CHAIN_EDGES,
                "route": "cuda",
                "source": f"acmpc_tpu_torch/csrc/{chain.EDGES_SOURCE}",
                "replaces": "acmpc_tpu/perception/tracks.py:62",
                "launches": sum(
                    p["launches"].get(chain.TRACK_CHAIN_EDGES, 0) for p in (perception, agent, tools, training)
                ),
                "max_abs_err": perception["chain_edges"]["max_abs_err"],
                "ms": edges["ms"],
                "plain_ms": edges["plain_ms"],
                "bound_ms": edges["bound_ms"],
                "bound_by": edges["bound_by"],
                "library_ms": None,
            },
            *(
                {
                    "name": name,
                    "route": "cuda",
                    "source": f"acmpc_tpu_torch/csrc/{jpeg.SOURCE}",
                    "replaces": "acmpc_tpu/perception/perceiver.py:48",
                    "launches": paths.get(name, 0),
                    "max_abs_err": 0,
                    "ms": sim_jpeg[f"{name}_ms"],
                    "plain_ms": sim_jpeg["plain_ms"],
                    "bound_ms": perception["jpeg_round_trip"]["kernel_bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": None,
                }
                for name in (jpeg.BLOCKS_KERNEL, jpeg.COLOUR_KERNEL)
            ),
            *(
                {
                    # Ruiz scaling, which XLA composed for the JAX package:
                    # the resident plan at horizon 50 and B = 256 (the
                    # sweep's), the streamed plan on the 1,953-point
                    # raceline at 10 passes (phase 3); the largest relative
                    # difference from the plain version
                    "name": name,
                    "route": "cuda",
                    "source": f"acmpc_tpu_torch/csrc/{ruiz.SOURCE}",
                    "replaces": "acmpc_tpu/qp/admm.py:126 (XLA)",
                    "launches": paths.get(name, 0),
                    "max_rel_err": row["max_rel_err"],
                    "ms": row["ms"],
                    "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": "bytes",
                    "library_ms": None,
                }
                for name, row in (
                    (ruiz.RESIDENT, kernel["ruiz"][f"n{n50}_B{BATCH}"]),
                    (ruiz.STREAMED, kernel["ruiz"]["n1953_B1"]),
                )
            ),
            {
                # the device-side chunk loop (a WHILE node's condition):
                # ms a trip of a loop whose body is one add, captured,
                # and the host loop's; the bound is its bytes a trip
                "name": graph_loop.SET_CONDITION,
                "route": "cuda",
                "source": f"acmpc_tpu_torch/csrc/{graph_loop.SOURCE}",
                "replaces": "acmpc_tpu/qp/admm.py:469",
                "launches": paths.get(graph_loop.SET_CONDITION, 0),
                "max_abs_err": compiled["loop"]["max_abs_err"],
                "ms": compiled["loop"]["ms_per_trip"],
                "plain_ms": compiled["loop"]["plain_ms_per_trip"],
                "bound_ms": 1e3 * LOOP_TRIP_BYTES / HBM_BYTES_PER_S,
                "bound_by": "bytes",
                "library_ms": None,
            },
            {
                # SegFormer's attention: PyTorch's kernels through the
                # pinned backend, ms a frame (16 blocks) under the profiler;
                # max_abs_err the worst logit gap of the frame's reference
                "name": "segformer attention (" + "+".join(segformer["pinned"]) + ")",
                "route": "library",
                "source": "torch.nn.functional.scaled_dot_product_attention",
                "replaces": None,
                "launches": segformer["attention"]["launches_per_frame"],
                "max_abs_err": max(segformer["reference"]["logit_gap"]),
                "ms": segformer["attention"]["ms_per_frame"],
                "plain_ms": segformer["attention_backends"]["frame_ms"]["MATH"],
                "bound_ms": segformer["attention"]["least_ms"],
                "bound_by": "operations",
                "library_ms": segformer["attention"]["ms_per_frame"],
            },
            {
                # Mask2Former's deformable sampling, which no TPU kernel
                # computed: phase 19 at the published shapes, a launch (one
                # encoder layer); launches over phase 19's frames; the
                # library's yardstick the grid_sample composition
                "name": "ms_deform_attn",
                "route": "cuda",
                "source": "acmpc_tpu_torch/csrc/ms_deform_attn.cu",
                "replaces": None,
                "launches": mask2former["launches_per_frame"] * MASK2FORMER_FRAMES,
                "max_abs_err": mask2former["kernel"]["max_abs_err"],
                "ms": mask2former["kernel"]["ms"],
                "plain_ms": mask2former["kernel"]["plain_ms"],
                "bound_ms": mask2former["kernel"]["bound_ms"],
                "bound_by": mask2former["kernel"]["bound_by"],
                "library_ms": mask2former["kernel"]["library_ms"],
            },
            {
                # SegFormer's head resample, which no TPU kernel computed:
                # phase 20 at 1280x736 bf16, a launch (one frame); launches
                # over phase 20's frames; the plain version is the library
                # composition (F.interpolate and torch.cat) the head ran
                # before; max_ulps over both frames, batches and dtypes
                "name": "segformer_resample",
                "route": "cuda",
                "source": "acmpc_tpu_torch/csrc/segformer_resample.cu",
                "replaces": None,
                "launches": resample["launches_per_frame"] * RESAMPLE_PERCEIVER_FRAMES,
                "max_ulps": max(r["max_ulps"] for r in resample["kernel_vs_plain"]),
                "ms": resample["timed"]["ms"],
                "plain_ms": resample["timed"]["plain_ms"],
                "bound_ms": resample["timed"]["bound_ms"],
                "bound_by": "bytes",
                "library_ms": resample["timed"]["plain_ms"],
            },
            {
                # Swin's window attention, which no TPU kernel computed:
                # phase 21, a frame's 24 blocks at Swin-L's stage shapes
                # timed alone; launches over phase 21's frames; the
                # library's yardstick SDPA on windows partitioned
                # beforehand with one float bias + mask
                "name": "window_attention",
                "route": "cuda",
                "source": "acmpc_tpu_torch/csrc/window_attention.cu",
                "replaces": None,
                "launches": swin["launches_per_frame"]["window_attention"] * SWIN_FRAMES,
                "max_abs_err": max(r["max_abs_err"] for r in swin["kernel"]["stages"]),
                "ms": swin["kernel"]["frame"]["ms"],
                "plain_ms": swin["kernel"]["frame"]["plain_ms"],
                "bound_ms": swin["kernel"]["frame"]["bound_ms"],
                "bound_by": "bytes",
                "library_ms": swin["kernel"]["frame"]["library_ms"],
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
    tools = phase_tools(agent)
    parallel = phase_parallel()
    vmapped = phase_vmapped()
    training = phase_training()
    compiled = phase_compiled()
    segformer = phase_segformer()
    mask2former = phase_mask2former()
    resample = phase_segformer_resample()
    swin = phase_swin()
    print(json.dumps(kernels_line(
        kernel, main_info, mapping, sweep, multi, perception, agent, tools, parallel, vmapped, training,
        compiled, segformer, mask2former, resample, swin,
    )))
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
