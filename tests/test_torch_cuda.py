"""On-card tests of the port (marker ``cuda``; they skip without a GPU).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import acmpc_tpu_torch.ops.admm_chunk as ops
from acmpc_tpu_torch.ops.admm_chunk import (
    CLUSTER,
    CLUSTER_ACTIVE,
    ChunkPlan,
    admm_chunk,
    admm_chunk_reference,
    plan_chunk,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, M, ITERS, ALPHA = 20, 30, 25, 1.6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _chunk_inputs(batch, seed, device, n=N, m=M, offset=0):
    """A well-posed ADMM operator per scenario (see
    test_torch_admm_chunk._inputs), built with numpy. ``offset`` > 0
    places each tensor ``offset`` floats into its allocation, so its base
    address is not 16-byte aligned."""
    N, M = n, m
    rng = np.random.default_rng(seed)
    sigma = 1e-5
    keys = ("W", "A", "c0", "rho", "l", "u", "x", "z", "y")
    out = {k: [] for k in keys}
    for _ in range(batch):
        Mx = rng.normal(size=(N, N))
        P = Mx @ Mx.T / N + 0.5 * np.eye(N)
        A = rng.normal(size=(M, N)) / np.sqrt(N)
        centre = A @ rng.normal(size=N)
        half = rng.uniform(0.5, 1.5, size=M)
        half[::7] = 0.0
        rho = np.where(half == 0.0, 100.0, 0.1)
        Kinv = np.linalg.inv(P + sigma * np.eye(N) + A.T @ (rho[:, None] * A))
        x = rng.normal(scale=0.1, size=N)
        for k, v in zip(keys, (
            np.concatenate([sigma * Kinv, Kinv @ A.T], axis=1), A,
            -Kinv @ rng.normal(size=N), rho, centre - half, centre + half, x,
            np.clip(A @ x, centre - half, centre + half),
            rng.normal(scale=0.1, size=M),
        )):
            out[k].append(v)
    tensors = []
    for k in keys:
        t = torch.as_tensor(np.stack(out[k]), dtype=torch.float32, device=device)
        if offset:
            flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
            t = flat[offset:].view(t.shape).copy_(t)
        tensors.append(t)
    return tensors


def _assert_matches(got, want):
    # reductions in another order than cuBLAS's over 25 dependent
    # iterations; rho = 100 rows scale the rounding of y: 1e-4 of the
    # iterates' scale, as chip_smoke.py
    torch.cuda.synchronize()
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0.0, atol=1e-4 * scale)


def _stream_plan(n, m):
    return ChunkPlan("stream", 1, ops.stream_smem_bytes(n, m))


def _largest_cluster_shape():
    h = max(h for h in range(2, 200) if plan_chunk(5 * h - 2, 8 * h - 2, 1).variant == "cluster")
    return 5 * h - 2, 8 * h - 2


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_reference_on_card(cuda_device, masked):
    # reductions in another order than cuBLAS's over 25 dependent
    # iterations; rho = 100 rows scale the rounding of y
    args = _chunk_inputs(7, 6, cuda_device)
    active = torch.arange(7, device=cuda_device) % 2 == 0 if masked else None
    admm_chunk.launches.clear()
    got = admm_chunk(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    want = admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    torch.cuda.synchronize()
    assert admm_chunk.launches[CLUSTER_ACTIVE if masked else CLUSTER] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


# (n, m): n + m odd; n + m = 2 mod 4 (W rows not 16-byte multiples);
# horizon 50; the largest shape the rule still gives to a cluster
SHAPES = {"odd": (21, 30), "2mod4": (20, 30), "h50": (248, 398), "largest": None}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cluster", "stream"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("masked", [False, True])
def test_variants_match_reference_on_card(cuda_device, variant, shape, masked):
    n, m = SHAPES[shape] or _largest_cluster_shape()
    batch = 3
    args = _chunk_inputs(batch, 11, cuda_device, n, m)
    active = torch.tensor([True, False, True], device=cuda_device) if masked else None
    plan = plan_chunk(n, m, batch) if variant == "cluster" else _stream_plan(n, m)
    assert plan.variant == variant
    admm_chunk.launches.clear()
    got = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA, active=active)
    want = admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    name = ops.CLUSTER if variant == "cluster" else ops.STREAM
    assert dict(admm_chunk.launches) == {f"{name}[active]" if masked else name: 1}
    _assert_matches(got, want)
    if masked:
        for g, start in zip(got, args[6:]):
            assert torch.equal(g[1], start[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "C, shape", [(1, "odd"), (5, "h50"), (8, "h50"), (16, "h50"), (16, "odd")]
)
def test_cluster_sizes_and_unaligned_bases_on_card(cuda_device, C, shape):
    # every cluster size takes any base address: the slices' ragged heads
    # and tails go by plain loads; at C = 16 and n = 21 five CTAs hold no
    # W rows
    n, m = SHAPES[shape]
    args = _chunk_inputs(2, 12, cuda_device, n, m, offset=1)
    assert args[0].data_ptr() % 16 != 0
    plan = ChunkPlan("cluster", C, ops.cluster_smem_bytes(n, m, C))
    got = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA)
    _assert_matches(got, admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cluster", "stream"])
def test_zero_iterations_on_card(cuda_device, variant):
    n, m = SHAPES["h50"]
    args = _chunk_inputs(2, 13, cuda_device, n, m)
    plan = plan_chunk(n, m, 2) if variant == "cluster" else _stream_plan(n, m)
    got = ops._launch(plan, *args, n_iters=0, alpha=ALPHA)
    torch.cuda.synchronize()
    for g, start in zip(got, args[6:]):
        assert torch.equal(g, start)


@pytest.mark.cuda
def test_refused_cluster_raises(cuda_device):
    # a cluster whose CTAs cannot hold their slices is refused, and the
    # call raises rather than falling back
    n, m = 498, 798
    args = _chunk_inputs(1, 14, cuda_device, n, m)
    plan = ChunkPlan("cluster", 16, ops.cluster_smem_bytes(n, m, 16))
    with pytest.raises(RuntimeError):
        ops._launch(plan, *args, n_iters=1, alpha=ALPHA)


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices(cuda_device):
    args = _chunk_inputs(2, 7, cuda_device)
    args[6] = args[6].cpu()
    with pytest.raises(ValueError):
        admm_chunk(*args, n_iters=1, alpha=ALPHA)


@pytest.mark.cuda
def test_batched_step_on_card_matches_cpu(cuda_device):
    # the same batch through the kernel and through the plain CPU path:
    # fp32 rounding in the kernel, the batched Cholesky and reductions
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=50)
    model = SpatialBicycleModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max)
    refs = torch.as_tensor(np.stack(list(battery(50).values())), dtype=torch.float32)
    out = {}
    for device in ("cpu", cuda_device):
        mpc = SpatialMPC(control, model, device=device)
        state, _ = mpc.batched_get_control_fused(mpc.initial_state(len(refs)), refs)
        out[str(device)] = state
    gpu, cpu = out[str(cuda_device)], out["cpu"]
    assert bool(cpu.solved.all()) and bool(gpu.solved.cpu().all())
    torch.testing.assert_close(
        gpu.projected_control.cpu(), cpu.projected_control, rtol=2e-3, atol=2e-3
    )
