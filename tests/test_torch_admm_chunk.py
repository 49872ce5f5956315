"""The ADMM chunk module on the CPU: its plain version against the Pallas
kernel (interpret mode), and the wrapper's checks. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.ops.pallas_admm import admm_iterations_pallas
from acmpc_tpu_torch.ops.admm_chunk import (
    KERNEL_NAMES,
    MAX_CLUSTER,
    SMEM_PER_BLOCK,
    admm_chunk,
    admm_chunk_reference,
    cluster_smem_bytes,
    plan_chunk,
    stream_smem_bytes,
)

N, M, ITERS, ALPHA = 20, 30, 25, 1.6
# fp32 GEMVs summed in another order (XLA's interpreted dot vs torch's
# matmul) over 25 dependent iterations; equality rows (rho = 100) scale
# that rounding by rho in y, so the absolute floor is 1e-4 of the O(1)
# iterates
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(batch, seed=0):
    """A well-posed ADMM operator per scenario: W = [sigma K^-1 | K^-1 A'],
    c0 = -K^-1 q for K = P + sigma I + A' diag(rho) A."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("W", "A", "c0", "rho", "l", "u", "x", "z", "y")}
    sigma = 1e-5
    for _ in range(batch):
        Mx = rng.normal(size=(N, N))
        P = Mx @ Mx.T / N + 0.5 * np.eye(N)
        A = rng.normal(size=(M, N)) / np.sqrt(N)
        centre = A @ rng.normal(size=N)
        half = rng.uniform(0.5, 1.5, size=M)
        half[::7] = 0.0
        rho = np.where(half == 0.0, 100.0, 0.1)
        Kinv = np.linalg.inv(P + sigma * np.eye(N) + A.T @ (rho[:, None] * A))
        out["W"].append(np.concatenate([sigma * Kinv, Kinv @ A.T], axis=1))
        out["A"].append(A)
        out["c0"].append(-Kinv @ rng.normal(size=N))
        out["rho"].append(rho)
        out["l"].append(centre - half)
        out["u"].append(centre + half)
        out["x"].append(rng.normal(scale=0.1, size=N))
        out["z"].append(np.clip(A @ out["x"][-1], centre - half, centre + half))
        out["y"].append(rng.normal(scale=0.1, size=M))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def _pallas(inp, active=None):
    """The JAX kernel on lane-padded inputs (NP = MP = 128), unpadded."""
    B = inp["x"].shape[0]
    NP = MP = 128
    W = np.zeros((B, NP, NP + MP), np.float32)
    W[:, :N, :N] = inp["W"][:, :, :N]
    W[:, :N, NP : NP + M] = inp["W"][:, :, N:]
    A = np.zeros((B, MP, NP), np.float32)
    A[:, :M, :N] = inp["A"]

    def pad(v, width, fill=0.0):
        out = np.full((B, width), fill, np.float32)
        out[:, : v.shape[1]] = v
        return jnp.asarray(out)

    xo, zo, yo = admm_iterations_pallas(
        jnp.asarray(W), jnp.asarray(A), pad(inp["c0"], NP), pad(inp["rho"], MP, 1.0),
        pad(inp["l"], MP), pad(inp["u"], MP), pad(inp["x"], NP), pad(inp["z"], MP),
        pad(inp["y"], MP), n_iters=ITERS, alpha=ALPHA, interpret=True,
        active=None if active is None else jnp.asarray(active),
    )
    return np.asarray(xo)[:, :N], np.asarray(zo)[:, :M], np.asarray(yo)[:, :M]


def _args(inp, device="cpu"):
    return [torch.as_tensor(inp[k], device=device) for k in ("W", "A", "c0", "rho", "l", "u", "x", "z", "y")]


def test_reference_matches_pallas():
    inp = _inputs(4)
    got = admm_chunk(*_args(inp), n_iters=ITERS, alpha=ALPHA)
    want = _pallas(inp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # the iterates moved: the comparison is not of inputs with inputs
    assert np.abs(want[0] - inp["x"]).max() > 1e-2


def test_reference_matches_pallas_with_active():
    # B = 5 is odd, so the Pallas kernel tiles one scenario per grid step
    # and its per-tile flag is per scenario, as the CUDA kernel's
    inp = _inputs(5, seed=1)
    active = np.array([True, False, True, False, False])
    got = admm_chunk(*_args(inp), n_iters=ITERS, alpha=ALPHA, active=torch.as_tensor(active))
    want = _pallas(inp, active)
    for g, w, start in zip(got, want, (inp["x"], inp["z"], inp["y"])):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        # inactive scenarios pass through bit for bit
        np.testing.assert_array_equal(g.numpy()[~active], start[~active])


def test_zero_iterations_is_identity():
    inp = _inputs(2, seed=2)
    got = admm_chunk(*_args(inp), n_iters=0, alpha=ALPHA)
    for g, k in zip(got, ("x", "z", "y")):
        np.testing.assert_array_equal(g.numpy(), inp[k])


def test_wrapper_rejects_bad_inputs():
    args = _args(_inputs(2, seed=3))
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(TypeError):
        admm_chunk(*bad_dtype, n_iters=1, alpha=ALPHA)
    bad_shape = list(args)
    bad_shape[6] = args[6][:, :-1].contiguous()
    with pytest.raises(ValueError):
        admm_chunk(*bad_shape, n_iters=1, alpha=ALPHA)
    strided = list(args)
    strided[1] = args[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError):
        admm_chunk(*strided, n_iters=1, alpha=ALPHA)
    with pytest.raises(ValueError):
        admm_chunk(*args, n_iters=1, alpha=ALPHA, active=torch.ones(3, dtype=torch.bool))


def test_no_silent_fallback_off_cpu():
    # a tensor that is neither on the CPU nor on a card is refused, not
    # quietly computed with the plain version
    meta = [a.to("meta") for a in _args(_inputs(1, seed=4))]
    with pytest.raises(ValueError):
        admm_chunk(*meta, n_iters=1, alpha=ALPHA)


def test_cpu_path_counts_no_launch():
    admm_chunk.launches.clear()
    args = _args(_inputs(3, seed=5))
    admm_chunk(*args, n_iters=2, alpha=ALPHA)
    admm_chunk(*args, n_iters=2, alpha=ALPHA, active=torch.tensor([True, False, True]))
    assert len(KERNEL_NAMES) == 4
    assert all(admm_chunk.launches[name] == 0 for name in KERNEL_NAMES)
    assert sum(admm_chunk.launches.values()) == 0


def _control_shape(horizon):
    """(n, m) of the control QP at a horizon: 5h - 2 variables, 8h - 2
    constraints (248 and 398 at horizon 50)."""
    return 5 * horizon - 2, 8 * horizon - 2


@pytest.mark.parametrize("batch", [1, 7, 15, 16, 256])
def test_plan_horizon50_takes_cluster(batch):
    n, m = _control_shape(50)
    plan = plan_chunk(n, m, batch)
    assert plan.variant == "cluster"
    assert plan.smem_bytes == cluster_smem_bytes(n, m, plan.cluster) <= SMEM_PER_BLOCK
    # the fewest CTAs that fit when the batch fills the card, at least 8
    # when 8-CTA clusters hold the whole batch at once
    assert plan.cluster == (8 if batch <= 15 else 5)


def test_plan_cluster_sizes_at_horizon50():
    n, m = _control_shape(50)
    # 50 + 80 rows of 2,584 and 992 bytes, the vectors and 4 mbarriers
    assert cluster_smem_bytes(n, m, 5) == 214_520
    assert cluster_smem_bytes(n, m, 4) > SMEM_PER_BLOCK
    sizes = [cluster_smem_bytes(n, m, C) for C in range(1, MAX_CLUSTER + 1)]
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_plan_horizon100_takes_stream(batch):
    # the mapping control: a 4.17 MB operator, above 16 x 227 KB
    n, m = _control_shape(100)
    assert cluster_smem_bytes(n, m, MAX_CLUSTER) > SMEM_PER_BLOCK
    plan = plan_chunk(n, m, batch)
    assert plan == type(plan)("stream", 1, stream_smem_bytes(n, m))


def test_plan_largest_cluster_shape():
    # the longest horizon whose operator a 16-CTA cluster still holds
    horizons = [h for h in range(2, 200) if plan_chunk(*_control_shape(h), 1).variant == "cluster"]
    largest = max(horizons)
    assert horizons == list(range(2, largest + 1))
    plan = plan_chunk(*_control_shape(largest), 1)
    assert plan.cluster == MAX_CLUSTER and plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan_chunk(*_control_shape(largest + 1), 1).variant == "stream"


def test_plan_depends_on_shapes_only():
    # B = 0 and tiny shapes still plan; the same inputs, the same plan
    assert plan_chunk(248, 398, 0) == plan_chunk(248, 398, 1)
    assert plan_chunk(N, M, 3).variant == "cluster"
    assert plan_chunk(N, M, 300).cluster == 1


def test_empty_batch_and_zero_iterations():
    args = [a[:0] for a in _args(_inputs(1, seed=6))]
    out = admm_chunk(*args, n_iters=ITERS, alpha=ALPHA)
    assert [tuple(o.shape) for o in out] == [(0, N), (0, M), (0, M)]
    inp = _inputs(3, seed=7)
    got = admm_chunk(*_args(inp), n_iters=0, alpha=ALPHA, active=torch.tensor([True, False, True]))
    for g, k in zip(got, ("x", "z", "y")):
        np.testing.assert_array_equal(g.numpy(), inp[k])
