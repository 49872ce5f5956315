"""On-card tests of the port (marker ``cuda``; they skip without a GPU).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.ops.admm_chunk import (
    KERNEL,
    KERNEL_ACTIVE,
    admm_chunk,
    admm_chunk_reference,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, M, ITERS, ALPHA = 20, 30, 25, 1.6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _chunk_inputs(batch, seed, device):
    """A well-posed ADMM operator per scenario (see
    test_torch_admm_chunk._inputs), built with numpy."""
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
    return [torch.as_tensor(np.stack(out[k]), dtype=torch.float32, device=device) for k in keys]


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
    assert admm_chunk.launches[KERNEL_ACTIVE if masked else KERNEL] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


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
