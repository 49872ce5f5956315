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
from acmpc_tpu_torch.ops.graph_loop import settle_launches
from acmpc_tpu_torch.ops.admm_chunk import (
    CLUSTER,
    CLUSTER_ACTIVE,
    CLUSTER_BOX,
    CLUSTER_BOX_ACTIVE,
    ChunkPlan,
    admm_chunk,
    admm_chunk_box_reference,
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
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("masked", [False, True])
def test_variants_match_reference_on_card(cuda_device, shape, masked):
    n, m = SHAPES[shape] or _largest_cluster_shape()
    batch = 3
    args = _chunk_inputs(batch, 11, cuda_device, n, m)
    active = torch.tensor([True, False, True], device=cuda_device) if masked else None
    plan = plan_chunk(n, m, batch)
    assert plan.variant == "cluster"
    admm_chunk.launches.clear()
    got = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA, active=active)
    want = admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    assert dict(admm_chunk.launches) == {ops.CLUSTER_ACTIVE if masked else ops.CLUSTER: 1}
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
def test_zero_iterations_on_card(cuda_device):
    n, m = SHAPES["h50"]
    args = _chunk_inputs(2, 13, cuda_device, n, m)
    plan = plan_chunk(n, m, 2)
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


# the split kernel (operators no cluster holds whole): horizon 100 as
# planned (16 CTAs, 38 of 50 A rows per CTA streamed); horizon 93, the
# first shape no cluster holds, where few rows stream; horizon 100 at
# C = 8, where more than half of each slice streams, W rows too
H100, H93 = (498, 798), (463, 742)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_split_matches_reference_at_horizon100_on_card(cuda_device, batch, masked):
    n, m = H100
    args = _chunk_inputs(batch, 20 + batch, cuda_device, n, m)
    active = torch.arange(batch, device=cuda_device) % 3 != 1 if masked else None
    admm_chunk.launches.clear()
    got = admm_chunk(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    want = admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA, active=active)
    assert dict(admm_chunk.launches) == {ops.SPLIT_ACTIVE if masked else ops.SPLIT: 1}
    _assert_matches(got, want)
    if masked and batch > 1:
        for g, start in zip(got, args[6:]):
            assert torch.equal(g[1], start[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, C, offset",
    [(H93, 16, 0), (H93, 16, 1), (H100, 8, 0), (H100, 8, 3), (H100, 12, 1), ((21, 30), 16, 1)],
)
def test_split_cluster_sizes_and_unaligned_bases_on_card(cuda_device, shape, C, offset):
    # bases 4 or 12 bytes past a 16-byte boundary: every resident slice and
    # every stage has a ragged head and tail; n + m = 51 is odd, and at
    # C = 16 with n = 21 some CTAs hold no rows
    n, m = shape
    lay = ops.split_layout(n, m, C)
    args = _chunk_inputs(2, 30 + C, cuda_device, n, m, offset=offset)
    got = ops._launch(ops.split_plan(n, m, C), *args, n_iters=ITERS, alpha=ALPHA)
    _assert_matches(got, admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA))
    if shape == H100 and C == 8:
        assert lay.res_w < lay.rows_w and lay.res_a == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_iters", [0, 1, 2])
@pytest.mark.parametrize("stages, stage_bytes", [(4, 8192), (1, 8192), (2, 16384)])
def test_split_few_iterations_and_rings_on_card(cuda_device, n_iters, stages, stage_bytes):
    # the ring's parity across phases and iterations: one stage, and a
    # stream shorter than the ring
    n, m = H100
    args = _chunk_inputs(2, 40 + n_iters, cuda_device, n, m)
    plan = ops.split_plan(n, m, 16, stages, stage_bytes)
    got = ops._launch(plan, *args, n_iters=n_iters, alpha=ALPHA)
    want = admm_chunk_reference(*args, n_iters=n_iters, alpha=ALPHA)
    if n_iters == 0:
        torch.cuda.synchronize()
        for g, start in zip(got, args[6:]):
            assert torch.equal(g, start)
    else:
        _assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_split_small_stream_on_card(cuda_device, offset):
    # a ring of four 57 KB stages leaves room for 14 of 21 W rows and no A
    # row: W's tail is smaller than one stage, and an iteration has fewer
    # stages (3) than the ring has slots; a stage of 16 rows gives every
    # consumer warp one row
    n, m = 21, 30
    lay = ops.split_layout(n, m, 1, 4, 57000)
    assert (lay.res_w, lay.res_a, lay.per_stage_w, lay.per_stage_a) == (14, 0, 16, 16)
    args = _chunk_inputs(3, 50, cuda_device, n, m, offset=offset)
    got = ops._launch(ops.split_plan(n, m, 1, 4, 57000), *args, n_iters=ITERS, alpha=ALPHA)
    _assert_matches(got, admm_chunk_reference(*args, n_iters=ITERS, alpha=ALPHA))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16])
def test_split_is_deterministic_on_card(cuda_device, C):
    # each sum has one fixed order, so any race between the ring, the
    # resident loads and the DSMEM exchange would show as a launch whose
    # bits differ from the first
    n, m = H100
    args = _chunk_inputs(8, 60 + C, cuda_device, n, m, offset=1)
    plan = ops.split_plan(n, m, C)
    first = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA)
    for _ in range(30):
        again = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA)
        torch.cuda.synchronize()
        for a, b in zip(again, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_refused_split_raises(cuda_device):
    # a layout in which not even the vectors and the ring fit is refused
    # by the library, and the call raises rather than falling back
    n, m = H100
    args = _chunk_inputs(1, 51, cuda_device, n, m)
    plan = ops.split_plan(n, m, 16, 16, 32768)
    assert plan.smem_bytes > ops.SMEM_PER_BLOCK
    with pytest.raises(RuntimeError):
        ops._launch(plan, *args, n_iters=1, alpha=ALPHA)


# -- the box block: A_s = [A_d; diag(g)], the operator W_s = [K^-1 | K^-1
# A_d'] (ops/admm_chunk.py). Each kernel against both plain versions: the
# box block's and the dense one on the same QP (W = [sigma K^-1 | K^-1
# A_s'], A_s), at the iterates' scale as above; the two plain versions
# differ by their own fp32 rounding (tests/test_torch_admm_box.py)
SIGMA = 1e-5
BOX_SHAPES = {
    "control": (20, 12), "raceline": (24, 0), "odd": (21, 9),
    "h50": (248, 150), "h100": (498, 300), "n586": (586, 0), "n1953": (1953, 0),
}


def _box_inputs(batch, seed, device, n, m_d, offset=0):
    """B QPs whose scaled A is [A_d; diag(g)] (as
    tests/test_torch_admm_box._qps, built with numpy): a dict of the dense
    chunk inputs ("W", "A"), the box block's ("Ws", "Ad", "g") and the
    vectors, fp32 on ``device``; ``offset`` as in :func:`_chunk_inputs`."""
    rng = np.random.default_rng(seed)
    m = m_d + n
    keys = ("W", "A", "Ws", "Ad", "g", "c0", "rho", "l", "u", "x", "z", "y")
    out = {k: [] for k in keys}
    for _ in range(batch):
        Mx = rng.normal(size=(n, n))
        P = Mx @ Mx.T / n + 0.5 * np.eye(n)
        Ad = rng.normal(size=(m_d, n)) / np.sqrt(n)
        g = rng.uniform(0.5, 2.0, size=n)
        A = np.concatenate([Ad, np.diag(g)])
        centre = A @ rng.normal(size=n)
        half = rng.uniform(0.2, 1.5, size=m)
        half[: m_d : 5] = 0.0
        rho = np.where(half == 0.0, 100.0, 0.1)
        Kinv = np.linalg.inv(P + SIGMA * np.eye(n) + A.T @ (rho[:, None] * A))
        x = rng.normal(scale=0.3, size=n)
        for k, v in zip(keys, (
            np.concatenate([SIGMA * Kinv, Kinv @ A.T], axis=1), A,
            np.concatenate([Kinv, Kinv @ Ad.T], axis=1), Ad, g,
            -Kinv @ rng.normal(size=n), rho, centre - half, centre + half, x,
            np.clip(A @ x, centre - half, centre + half),
            rng.normal(scale=0.1, size=m),
        )):
            out[k].append(v)
    tensors = {}
    for k in keys:
        t = torch.as_tensor(np.stack(out[k]), dtype=torch.float32, device=device)
        if offset:
            flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
            t = flat[offset:].view(t.shape).copy_(t)
        tensors[k] = t
    return tensors


VECS = ("c0", "rho", "l", "u", "x", "z", "y")


def _box_args(inp):
    return [inp[k] for k in ("Ws", "Ad", *VECS)], dict(g=inp["g"], sigma=SIGMA)


def _box_both(inp, n_iters=ITERS, active=None):
    """(the box block's plain version, the dense one)."""
    args, kw = _box_args(inp)
    box = admm_chunk_box_reference(*args, n_iters=n_iters, alpha=ALPHA, active=active, **kw)
    dense = admm_chunk_reference(
        *(inp[k] for k in ("W", "A", *VECS)), n_iters=n_iters, alpha=ALPHA, active=active
    )
    return box, dense


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["control", "raceline", "odd", "h50", "h100", "n586"])
@pytest.mark.parametrize("masked", [False, True])
def test_box_cluster_matches_both_references_on_card(cuda_device, shape, masked):
    n, m_d = BOX_SHAPES[shape]
    inp = _box_inputs(3, 70, cuda_device, n, m_d)
    active = torch.tensor([True, False, True], device=cuda_device) if masked else None
    plan = plan_chunk(n, m_d + n, 3, n)
    assert plan.variant == "cluster" and plan.box
    args, kw = _box_args(inp)
    admm_chunk.launches.clear()
    got = admm_chunk(*args, n_iters=ITERS, alpha=ALPHA, active=active, **kw)
    assert dict(admm_chunk.launches) == {CLUSTER_BOX_ACTIVE if masked else CLUSTER_BOX: 1}
    for want in _box_both(inp, active=active):
        _assert_matches(got, want)
    if masked:
        for g, start in zip(got, args[6:]):
            assert torch.equal(g[1], start[1])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, C", [("odd", 1), ("odd", 16), ("raceline", 3), ("h50", 3), ("h50", 8), ("h50", 16), ("h100", 16)]
)
def test_box_cluster_sizes_and_unaligned_bases_on_card(cuda_device, shape, C):
    # any cluster size and base address; at C = 16 and n = 21 five CTAs
    # hold no W rows, and at m_d = 9 seven hold no A rows
    n, m_d = BOX_SHAPES[shape]
    inp = _box_inputs(2, 71, cuda_device, n, m_d, offset=1)
    assert inp["Ws"].data_ptr() % 16 != 0
    args, kw = _box_args(inp)
    got = ops._launch(ops.cluster_plan(n, m_d + n, C, n), *args, n_iters=ITERS, alpha=ALPHA, **kw)
    for want in _box_both(inp):
        _assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, C, offset", [("odd", 16, 1), ("h100", 8, 1), ("h100", 16, 0), ("n1953", 16, 0), ("n1953", 16, 3)]
)
@pytest.mark.parametrize("masked", [False, True])
def test_box_split_matches_both_references_on_card(cuda_device, shape, C, offset, masked):
    # the split kernel on the box block: at horizon 100 with C = 8 W rows
    # and every A_d row stream; at 1,953 points, as planned, 101 of each
    # CTA's 123 rows of W_s stream and there is no A_d
    n, m_d = BOX_SHAPES[shape]
    batch = 1 if n > 1000 else 3
    inp = _box_inputs(batch, 72 + C, cuda_device, n, m_d, offset=offset)
    active = (torch.arange(batch, device=cuda_device) != 1) if masked else None
    plan = ops.split_plan(n, m_d + n, C, n_b=n)
    if shape == "n1953":
        assert plan == plan_chunk(n, m_d + n, batch, n)
    args, kw = _box_args(inp)
    admm_chunk.launches.clear()
    got = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA, active=active, **kw)
    assert dict(admm_chunk.launches) == {ops.SPLIT_BOX_ACTIVE if masked else ops.SPLIT_BOX: 1}
    for want in _box_both(inp, active=active):
        _assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cluster", "split"])
def test_box_zero_and_few_iterations_on_card(cuda_device, variant):
    n, m_d = BOX_SHAPES["h50"]
    inp = _box_inputs(2, 73, cuda_device, n, m_d)
    args, kw = _box_args(inp)
    plan = plan_chunk(n, m_d + n, 2, n) if variant == "cluster" else ops.split_plan(n, m_d + n, 8, n_b=n)
    got = ops._launch(plan, *args, n_iters=0, alpha=ALPHA, **kw)
    torch.cuda.synchronize()
    for g, start in zip(got, args[6:]):
        assert torch.equal(g, start)
    for n_iters in (1, 2):
        got = ops._launch(plan, *args, n_iters=n_iters, alpha=ALPHA, **kw)
        for want in _box_both(inp, n_iters=n_iters):
            _assert_matches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["h100", "n1953"])
def test_box_kernels_are_deterministic_on_card(cuda_device, shape):
    # each sum has one fixed order: a race in the exchange, the box rows'
    # update or the ring would show as a launch whose bits differ
    n, m_d = BOX_SHAPES[shape]
    batch = 1 if n > 1000 else 8
    inp = _box_inputs(batch, 74, cuda_device, n, m_d, offset=1)
    args, kw = _box_args(inp)
    plan = plan_chunk(n, m_d + n, batch, n)
    first = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA, **kw)
    for _ in range(20):
        again = ops._launch(plan, *args, n_iters=ITERS, alpha=ALPHA, **kw)
        torch.cuda.synchronize()
        for a, b in zip(again, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_box_cluster_occupancy_on_card(cuda_device):
    # the box block's plans schedule: horizon 50 at C = 3, horizon 100 at
    # C = 10 (the non-portable cluster size), the 586-point raceline at 8
    for n, m_d, batch in ((248, 150, 256), (498, 300, 8), (586, 0, 1)):
        plan = plan_chunk(n, m_d + n, batch, n)
        assert ops.max_active_clusters(plan, n, m_d + n, cuda_device.index or 0) >= 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("adaptive", [True, False])
def test_batched_solve_matches_single_solves_on_card(cuda_device, adaptive):
    """solve_box_qp over a scenario axis on the card: one chunk launch for
    every lane, each lane against its unbatched solve. Status equal; x at
    the tolerance for converged solves whose arithmetic differs in
    rounding (tests/test_torch_admm.py's X_TOL): the batch goes through
    batched products and another cluster size than a single QP."""
    from acmpc_tpu_torch.qp.admm import ADMMConfig, solve_box_qp

    rng = np.random.default_rng(3)
    qps = []
    for _ in range(6):
        Mx = rng.normal(size=(N, N))
        A = rng.normal(size=(M, N))
        centre = A @ rng.normal(size=N)
        half = np.abs(rng.normal(size=M)) + 0.5
        lo, hi = centre - half, centre + half
        hi[:3] = lo[:3]
        qps.append([Mx @ Mx.T + 0.5 * np.eye(N), rng.normal(size=N), A, lo, hi])
    stacked = [torch.as_tensor(np.stack([qp[i] for qp in qps]), dtype=torch.float32, device=cuda_device)
               for i in range(5)]
    cfg = ADMMConfig() if adaptive else ADMMConfig(adaptive_rho=False, rho=0.01, max_iter=20000)
    admm_chunk.launches.clear()
    batch = solve_box_qp(*stacked, cfg)
    assert sum(admm_chunk.launches.values()) == int(batch.iterations.max()) // cfg.check_every
    assert bool(batch.solved.all())
    for i in range(len(qps)):
        single = solve_box_qp(*(t[i] for t in stacked), cfg)
        assert int(single.status) == int(batch.status[i])
        torch.testing.assert_close(batch.x[i], single.x, rtol=2e-2, atol=2e-2)


# -- the closed loop and the all-tracks solve (no JAX on the card machine)
TRACKS = [
    "monza", "spa", "silverstone", "nordschleife",
    "vallelunga", "bathurst", "yas_marina",
]


@pytest.mark.cuda
def test_load_track_map_places_tensors_on_card(cuda_device):
    from acmpc_tpu_torch.bench.full_lap import MAP
    from acmpc_tpu_torch.localise.track_map import load_track_map

    tm = load_track_map(MAP)  # the entry point's default device
    cpu = load_track_map(MAP, device="cpu")
    for field in ("centre", "left", "right"):
        t = getattr(tm, field)
        assert t.device.type == "cuda" and t.dtype == torch.float32
        assert torch.equal(t.cpu(), getattr(cpu, field))


@pytest.mark.cuda
def test_lap_sweep_on_card_matches_cpu_step_by_step(cuda_device):
    # teacher forcing: each step of the card's run, from its cars and
    # states, through the port on the CPU. The windows (argmins on the
    # same fp32 inputs) agree exactly; commands to the card-vs-CPU
    # tolerance of chip_smoke.py (fp32 rounding in the kernel, the
    # batched Cholesky and the reductions)
    from acmpc_tpu_torch.bench.full_lap import HALF_WIDTH, MAP, closed_loop_mpc
    from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
    from acmpc_tpu_torch.localise.track_map import load_track_map

    def sweep_on(device):
        return LapSweep(
            closed_loop_mpc(device), load_track_map(MAP, device=device), half_width=HALF_WIDTH
        )

    gpu, cpu = sweep_on(cuda_device), sweep_on("cpu")
    grid = SweepGrid.perturbed(torch.Generator(device=cuda_device).manual_seed(1), 8, gpu.map.n_centre, 24.0)

    def host(tree):
        return type(tree)(*(getattr(tree, f.name).cpu() for f in dataclasses.fields(tree)))

    cars, states, prev = gpu.start(grid)
    gpu.fused_step(cars, states, grid.v_max, prev)  # captures the step's graph
    settle_launches()
    admm_chunk.launches.clear()
    for step in range(10):
        c_cars, c_states, c_metrics, c_i0 = cpu.fused_step(
            host(cars), host(states), grid.v_max.cpu(), prev.cpu()
        )
        cars, states, metrics, prev = gpu.fused_step(cars, states, grid.v_max, prev)
        assert torch.equal(prev.cpu(), c_i0), step
        assert bool(metrics["solved"].all()) and bool(c_metrics["solved"].all()), step
        torch.testing.assert_close(
            states.projected_control.cpu(), c_states.projected_control, rtol=2e-3, atol=2e-3
        )
        torch.testing.assert_close(metrics["v"].cpu(), c_metrics["v"], rtol=2e-3, atol=2e-3)
    settle_launches()
    assert dict(admm_chunk.launches) == {CLUSTER_BOX: 10}


def _straggling_sweep(device):
    """The racing controller (horizon 50, the chunk loop to ``max_iter``)
    on monza at the sweep benchmark's half width, its tolerances tightened
    to 2e-5 and its budget cut to 500 iterations, so that from zero warm
    starts the lanes of a step leave the chunk loop at different trips."""
    from acmpc_tpu_torch.bench.lap_sweep import LapSweep
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = cfg.racing_control
    model = SpatialBicycleModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max)
    mpc = SpatialMPC(control, model, device=device)
    mpc.admm = dataclasses.replace(mpc.admm, eps_abs=2e-5, eps_rel=2e-5, max_iter=500)
    return LapSweep(mpc, load_track_map(ROOT / "data" / "maps" / "monza.npz", device=device), half_width=5.0)


def _flat_step(out):
    cars, states, metrics, i0 = out
    return (*dataclasses.astuple(cars), *dataclasses.astuple(states), *metrics.values(), i0), list(metrics)


def _settled_chunks():
    settle_launches()
    n = sum(admm_chunk.launches.values())
    admm_chunk.launches.clear()
    return n


@pytest.mark.cuda
def test_fused_step_graph_equals_eager_on_card(cuda_device):
    """``LapSweep.fused_step`` as one CUDA graph a batch (the chunk loop a
    WHILE node) against the eager step on the card, bit for bit: three
    steps from zero warm starts with carried states, at B = 256 and 32,
    the graph's chunk launches (its loop trips, settled) equal to the
    eager step's, one graph cached a batch."""
    from acmpc_tpu_torch.bench.lap_sweep import SweepGrid

    sweep = _straggling_sweep(cuda_device)
    eager_step = sweep.mpc.batched_get_control_fused
    for n_graphs, batch in enumerate((256, 32), start=1):
        grid = SweepGrid.perturbed(
            torch.Generator(device=cuda_device).manual_seed(batch), batch, sweep.map.n_centre, 24.0
        )
        start = sweep.start(grid)
        sweep.fused_step(*start[:2], grid.v_max, start[2])  # the capture
        assert len(sweep._fused_graphs.graphs) == n_graphs
        _settled_chunks()
        eager = graph = start
        for step in range(3):
            eager = sweep._step(eager[0], eager[1], grid.v_max, eager[-1], eager_step)
            eager_chunks = _settled_chunks()
            graph = sweep.fused_step(graph[0], graph[1], grid.v_max, graph[-1])
            assert _settled_chunks() == eager_chunks, (batch, step)
            got, got_keys = _flat_step(graph)
            want, want_keys = _flat_step(eager)
            assert got_keys == want_keys
            for i, (a, b) in enumerate(zip(got, want)):
                assert a.dtype == b.dtype and torch.equal(a, b), (batch, step, i)
            its = eager[2]["control_iterations"]
            if step == 0:
                # several trips, lanes done at different ones
                assert int(its.max()) > 2 * sweep.mpc.admm.check_every, batch
                assert len(torch.unique(its)) > 2, batch
        assert len(sweep._fused_graphs.graphs) == n_graphs


@pytest.mark.cuda
def test_fused_step_replays_once_a_step_with_the_monitor_on(cuda_device, monitor_on):
    """With the monitor on, the step's graph (captured with it on) counts
    one replay a step and no capture after its first call, and hands out
    what the graph captured with the monitor off does."""
    from acmpc_tpu_torch.bench.lap_sweep import SweepGrid

    sweep = _straggling_sweep(cuda_device)
    grid = SweepGrid.perturbed(torch.Generator(device=cuda_device).manual_seed(32), 32, sweep.map.n_centre, 24.0)
    cars, states, prev = start = sweep.start(grid)
    on = sweep.fused_step(cars, states, grid.v_max, prev)
    monitor_on.clear()
    for _ in range(3):
        on = sweep.fused_step(on[0], on[1], grid.v_max, on[-1])
    counters = monitor_on.take()["counters"]
    assert counters == {"graph.replay:LapSweep.fused_step": 3}
    monitor_on.disable()
    off = sweep.fused_step(*start[:2], grid.v_max, start[2])
    for _ in range(3):
        off = sweep.fused_step(off[0], off[1], grid.v_max, off[-1])
    assert len(sweep._fused_graphs.graphs) == 2
    for a, b in zip(_flat_step(on)[0], _flat_step(off)[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_multi_track_on_card_matches_golden(cuda_device):
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.geometry.tracks import get_hairpin_track, with_widths
    from acmpc_tpu_torch.mpc.multi_track import MultiTrackMPC
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    agent = [load_config(ROOT / "configs" / f"{t}.yaml") for t in TRACKS]
    configs = [dataclasses.replace(c.racing_control, horizon=50) for c in agent]
    model = SpatialBicycleModel(agent[0].vehicle, configs[0].constraints.v_min, configs[0].constraints.v_max)
    mt = MultiTrackMPC(SpatialMPC(configs[0], model, device=cuda_device), configs)
    refs = np.stack([with_widths(get_hairpin_track(40.0 + 5 * i, 50)) for i in range(len(TRACKS))])
    caps = np.array([min(30.0, c.unlocalised_max_speed or 30.0) for c in configs], np.float32)
    admm_chunk.launches.clear()
    out, _ = mt.get_control(mt.initial_states(), refs.astype(np.float32), caps)
    assert admm_chunk.launches[CLUSTER_BOX] > 0
    golden = np.load(ROOT / "tests" / "fixtures" / "golden_controls.npz")
    np.testing.assert_array_equal(out.solved.cpu().numpy(), golden["multi_track/solved"])
    for field in ("projected_control", "cum_time"):
        # the fixture's own tolerance (tests/test_golden.py)
        np.testing.assert_allclose(
            getattr(out, field).cpu().numpy(), golden[f"multi_track/{field}"],
            rtol=5e-3, atol=5e-3, err_msg=field,
        )


# -- perception: the connected runs and the Perceiver on the card
def _perception_cases(n_poses: int = 4):
    """(mask, bonnet row) at 1280x736: the four adversarial masks scaled
    up, and masks the port's sim renders at ``n_poses`` poses of the
    perception loop's circuit."""
    from acmpc_tpu_torch.bench import perception_loop as loop

    cfg = loop.perception_config()
    masks, bonnet = loop.adversarial_masks(cfg.image_height, cfg.image_width)
    cases = [(m, bonnet) for m in masks.values()]
    centre, left, right, _ = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    cases += [(m, cfg.n_rows_to_remove_bonnet) for m in loop.sim_masks(sim, centre, n_poses)]
    return cases


@pytest.mark.cuda
def test_connected_runs_launch_the_kernel_once_on_card(cuda_device):
    # the connected runs are the fused kernel's mask
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges
    from acmpc_tpu_torch.perception.tracks import select_vehicle_connected_runs

    mask, bonnet = _perception_cases(1)[-1]
    chain_edges.launches.clear()
    got = select_vehicle_connected_runs(torch.as_tensor(mask, device=cuda_device), bonnet, band=4)
    want = select_vehicle_connected_runs(torch.as_tensor(mask), bonnet, band=4)
    assert dict(chain_edges.launches) == {TRACK_CHAIN_EDGES: 1}
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)


# -- the fused chain-edges kernel (csrc/track_chain_edges.cu)


def _assert_edges_equal(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [1, 2, 3, 4])
def test_chain_edges_kernel_matches_plain_on_card(cuda_device, band):
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges, chain_edges_reference

    cases = _perception_cases()
    chain_edges.launches.clear()
    for mask, bonnet in cases:
        for dtype in (torch.uint8, torch.bool):
            m = torch.as_tensor(mask, device=cuda_device).to(dtype)
            want = chain_edges_reference(m, bonnet, 3, band, return_mask=True)
            _assert_edges_equal(chain_edges(m, bonnet, 3, band, return_mask=True), want)
            _assert_edges_equal(chain_edges(m, bonnet, 3, band), want[:3])
    assert dict(chain_edges.launches) == {TRACK_CHAIN_EDGES: 4 * len(cases)}


def _edge_frames(rng, H, W):
    """Random streaks at two densities, full rows, an empty frame and a
    frame whose chain never starts."""
    frames = []
    for density in (0.6, 0.95):
        f = rng.random((H, W)) < density
        for r in range(H - 2, -1, -1):  # runs that merge, split and break
            f[r] |= f[r + 1] & (rng.random(W) < 0.5)
        frames.append(f)
    outside = np.zeros((H, W), bool)
    outside[:, : max(0, W // 3 - 1)] = True
    outside[:, 2 * W // 3 + 1 :] = True
    return frames + [np.ones((H, W), bool), np.zeros((H, W), bool), outside]


@pytest.mark.cuda
def test_chain_edges_kernel_widths_gaps_and_bonnets_on_card(cuda_device):
    from acmpc_tpu_torch.ops.track_chain import chain_edges, chain_edges_reference

    rng = np.random.default_rng(0)
    # one column, words and rounds of 32 lanes cut anywhere, the widest
    for H, W in ((9, 1), (13, 7), (30, 63), (30, 64), (30, 65), (41, 100), (33, 300),
                 (40, 1280), (23, 1281), (21, 2049), (19, 2500), (17, 4096), (12, 8192)):
        for frame in _edge_frames(rng, H, W):
            for bonnet in (H - 2, H, 0, H + 3):
                for gap, band in ((0, 1), (1, 1), (3, 1), (3, 2), (3, 3), (5, 4), (2, 7)):
                    m = torch.as_tensor(frame.astype(np.uint8), device=cuda_device)
                    want = chain_edges_reference(m, bonnet, gap, band, return_mask=True)
                    _assert_edges_equal(chain_edges(m, bonnet, gap, band, return_mask=True), want)


@pytest.mark.cuda
def test_chain_edges_kernel_on_an_unaligned_mask_on_card(cuda_device):
    # a contiguous mask whose base is not 16-byte aligned: the kernel
    # takes byte loads
    from acmpc_tpu_torch.ops.track_chain import chain_edges, chain_edges_reference

    mask, bonnet = _perception_cases(1)[0]
    H, W = mask.shape
    flat = torch.zeros(H * W + 1, dtype=torch.uint8, device=cuda_device)
    m = flat[1:].view(H, W).copy_(torch.as_tensor(mask))
    assert m.is_contiguous() and m.data_ptr() % 16 == 1
    for band in (1, 4):
        want = chain_edges_reference(m, bonnet, 3, band, return_mask=True)
        _assert_edges_equal(chain_edges(m, bonnet, 3, band, return_mask=True), want)
    # and a transposed one, made contiguous by the wrapper
    t = torch.as_tensor(np.ascontiguousarray(mask.T), device=cuda_device).T
    want = chain_edges_reference(t, bonnet, 3, 4, return_mask=True)
    _assert_edges_equal(chain_edges(t, bonnet, 3, 4, return_mask=True), want)


@pytest.mark.cuda
def test_chain_edges_on_a_cpu_tensor_takes_the_plain_version(cuda_device):
    from acmpc_tpu_torch.ops.track_chain import chain_edges, chain_edges_reference

    mask, bonnet = _perception_cases(1)[-1]
    m = torch.as_tensor(mask)
    chain_edges.launches.clear()
    got = chain_edges(m, bonnet, 3, 4, return_mask=True)
    assert sum(chain_edges.launches.values()) == 0
    assert all(g.device.type == "cpu" for g in got)
    for g, w in zip(got, chain_edges_reference(m, bonnet, 3, 4, return_mask=True)):
        assert torch.equal(g, w)
    card = chain_edges(m.to(cuda_device), bonnet, 3, 4, return_mask=True)
    for g, c in zip(got, card):
        assert torch.equal(g, c.cpu())


@pytest.mark.cuda
def test_chain_edges_refuses_unsupported_shapes_on_card(cuda_device):
    from acmpc_tpu_torch.ops import track_chain

    track_chain.chain_edges.launches.clear()
    bad = [
        (torch.zeros(1500, 1280, dtype=torch.uint8, device=cuda_device), 3, ValueError),  # shared memory
        (torch.zeros(4, track_chain.EDGES_MAX_WIDTH + 1, dtype=torch.uint8, device=cuda_device), 3, ValueError),
        (torch.zeros(4, 64, dtype=torch.float32, device=cuda_device), 3, TypeError),
        (torch.zeros(64, dtype=torch.uint8, device=cuda_device), 3, ValueError),
        (torch.zeros(2, 4, 64, dtype=torch.uint8, device=cuda_device), 3, ValueError),
        (torch.zeros(0, 64, dtype=torch.uint8, device=cuda_device), 3, ValueError),
        (torch.zeros(4, 64, dtype=torch.uint8, device=cuda_device), -1, ValueError),
    ]
    for mask, gap, error in bad:
        with pytest.raises(error):
            track_chain.chain_edges(mask, 2, gap, 1)
    with pytest.raises(ValueError):  # the kernel's entry takes CUDA tensors only
        track_chain._launch_edges(torch.zeros(4, 64, dtype=torch.uint8), 2, 3, 1, False)
    assert sum(track_chain.chain_edges.launches.values()) == 0


@pytest.mark.cuda
def test_perceiver_on_card_matches_cpu_fp32(cuda_device):
    # the shipped checkpoint at 320x192 in fp32 (TF32 off): cuDNN and the
    # CPU sum each convolution in other orders, so only near-tie pixels
    # may flip; a flipped edge pixel moves a boundary point, hence the
    # polylines' 0.05 m (tests/test_torch_perception.py's tolerance for it)
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    cfg = loop.perception_config(320, 192, "fp32")
    centre, left, right, _ = loop.circuit()
    frame = loop.make_sim(cfg, centre, left, right).reset()["image"]
    out = {}
    chain_edges.launches.clear()
    for device in ("cpu", cuda_device):
        perc = Perceiver(cfg, device=device)
        drivable, semantics, tracks = perc._run_pipeline(torch.as_tensor(frame, device=device))
        assert drivable.device.type == torch.device(device).type
        out[str(device)] = (drivable.cpu(), semantics.cpu(), {k: v.cpu() for k, v in tracks.items()})
    assert dict(chain_edges.launches) == {TRACK_CHAIN_EDGES: 1}
    (d_gpu, s_gpu, t_gpu), (d_cpu, s_cpu, t_cpu) = out[str(cuda_device)], out["cpu"]
    assert (d_gpu == d_cpu).float().mean() >= 0.999
    assert (s_gpu == s_cpu).float().mean() >= 0.999
    for key in ("left", "right", "centre"):
        torch.testing.assert_close(t_gpu[key], t_cpu[key], rtol=1e-3, atol=0.05)


@pytest.mark.cuda
def test_particle_filter_on_card_matches_cpu(cuda_device):
    """The monza filter's predict, update and forced resample on the card
    against the CPU, one call each from one state with one set of
    scripted draws; and the blind reset on two maps."""
    from acmpc_tpu_torch.bench import locbench

    agree = locbench.devices_agree()
    for call, row in agree.items():
        allowed = locbench.MOVED_DRAWS_MAX_SHARE * 500 if call == "resample" else 0
        assert row["moved"] <= allowed and row["valid_equal"] and row["converged_equal"], (call, row)
    for track, row in locbench.reset_states_agree(["monza", "nordschleife"]).items():
        assert row["max_xy_m"] <= locbench.CARD_CPU_XY_M, track
        assert row["max_yaw_rad"] <= locbench.CARD_CPU_YAW_RAD, track


@pytest.mark.cuda
def test_particle_filter_update_reads_nothing_back(cuda_device):
    from acmpc_tpu_torch.bench import locbench

    assert locbench.sync_free(pairs=10)["finite"]


@pytest.mark.cuda
def test_monza_realperc_replays_on_card_within_fixture_bounds(cuda_device):
    from acmpc_tpu_torch.bench import locbench

    rows = [locbench.replay("monza_realperc", seed, None, cuda_device) for seed in (0, 1, 2)]
    assert locbench.check(rows, locbench.load_fixture()) == [], rows
    assert all(row["observation_sync_p50_ms"] is not None for row in rows)


# -- the racing agent (runtime shell) ------------------------------------


def _agent_config(map_path, horizon=None):
    """monza's config at the e2e tests' camera (320x192, bonnet 160, 200
    polyfit points), localisation off; ``horizon`` cuts both MPCs."""
    from acmpc_tpu_torch.config import load_config

    r = dataclasses.replace
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    cfg = r(
        cfg,
        perception=r(cfg.perception, image_width=320, image_height=192,
                     n_rows_to_remove_bonnet=160, n_polyfit_points=200),
        localisation=r(cfg.localisation, use_localisation=False),
        map_path=str(map_path),
    )
    if horizon is not None:
        cfg = r(
            cfg,
            racing_control=r(cfg.racing_control, horizon=horizon,
                             constraints=r(cfg.racing_control.constraints, v_max=30.0)),
            mapping_control=r(cfg.mapping_control, horizon=horizon),
        )
    return cfg


def _loop_map(tmp_path):
    """bench.py's asymmetric ~1.3 km circuit, saved as .npz."""
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.localise.track_map import save_track_map

    centre, left, right, _ = loop.circuit()
    save_track_map(tmp_path / "loop.npz", centre, left, right)
    return tmp_path / "loop.npz", centre


def _sim(cfg, map_path, start_index=50):
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

    return SyntheticSimulator(
        load_track_map(map_path, device="cpu"), CameraInfo.from_config(cfg.perception),
        dt=0.05, start_index=start_index, half_width=5.0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["racing", "mapping"])
def test_controller_solve_on_card_matches_cpu(cuda_device, tmp_path, mode):
    """The control thread's solve at monza's horizons (racing 50, mapping
    100) on perceived centrelines, card against CPU: the published
    commands within 5e-3, through the cluster or the split kernel."""
    from acmpc_tpu_torch.perception.tracks import TrackExtractionConfig, TrackLimitExtractor
    from acmpc_tpu_torch.runtime.controller import Controller, _ControlThread

    map_path, centre = _loop_map(tmp_path)
    cfg = dataclasses.replace(_agent_config(map_path), create_map=mode == "mapping")
    sim = _sim(cfg, map_path)
    extractor = TrackLimitExtractor(TrackExtractionConfig.from_config(cfg.perception), sim.camera, "cpu")
    controllers = {d: Controller(cfg, device=d) for d in ("cpu", cuda_device)}
    threads = {d: _ControlThread(c) for d, c in controllers.items()}
    settle_launches()
    ops.admm_chunk.launches.clear()
    for k, i in enumerate((50, 400, 900)):
        p0, p1 = centre[i], centre[i + 1]
        sim.x, sim.y = float(p0[0]), float(p0[1])
        sim.yaw = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0])) + 0.05
        line = extractor.extract(torch.as_tensor(sim.render_drivable_mask()))["centre"].numpy()
        for d, thread in threads.items():
            thread._solve(line, float(k))
        (want, _, _), (got, _, _) = (controllers[d]._command_box.read() for d in ("cpu", cuda_device))
        assert got is not None and want is not None, "a solve was not published"
        for field in ("controls", "cum_time", "prediction"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=5e-3, atol=5e-3,
                                       err_msg=f"{mode} {k} {field}")
    # the mapping control (horizon 100) as the racing one: a cluster on
    # the box block (the captured step's chunks, settled from the card)
    settle_launches()
    assert ops.admm_chunk.launches.get(CLUSTER_BOX, 0) >= 3
    assert controllers[cuda_device].mpc.horizon == (100 if mode == "mapping" else 50)


@pytest.mark.cuda
def test_agent_drive_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """30 synchronous frames of the agent (oracle perception, horizon 20)
    on the card and on the CPU from the same observations on one fake
    clock, the sim driven by the CPU agent's action: the actions within
    5e-3 and the same command sets; the card's agent launched the
    cluster and the chain-edges kernels."""
    import types

    import acmpc_tpu_torch.runtime.pid as pid_module
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges
    from acmpc_tpu_torch.perception.observations import ObservationDict
    from acmpc_tpu_torch.runtime import Agent

    map_path, _ = _loop_map(tmp_path)
    cfg = _agent_config(map_path, horizon=20)
    clock = types.SimpleNamespace(t=0.0)
    now = lambda: clock.t  # noqa: E731
    monkeypatch.setattr(pid_module, "time", types.SimpleNamespace(monotonic=now))
    sim_clock = types.SimpleNamespace(clock=now, close=lambda: None)
    agents = {d: Agent(cfg, sim_clock, use_oracle_perception=True, device=d) for d in ("cpu", cuda_device)}
    threads = {}
    for d, agent in agents.items():
        threads[d] = agent.controller._thread
        agent.controller.shutdown()
    sim = _sim(cfg, map_path)
    raw = sim.reset()
    settle_launches()
    ops.admm_chunk.launches.clear()
    chain_edges.launches.clear()
    try:
        for k in range(30):
            clock.t = sim.t
            actions = {}
            for d, agent in agents.items():
                agent._maybe_setup_racing()
                obs = ObservationDict(raw)
                agent._update_perception(obs, raw)
                threads[d]._solve(*agent.controller._centreline_box.read()[0])
                agent._step(obs)
                actions[d] = agent.control_input
            np.testing.assert_allclose(actions[cuda_device], actions["cpu"], rtol=5e-3, atol=5e-3,
                                       err_msg=f"frame {k}")
            raw = sim.step(actions["cpu"])
        versions = {d: a.controller.command_version for d, a in agents.items()}
        assert versions[cuda_device] == versions["cpu"] == 30
    finally:
        for agent in agents.values():
            agent.teardown()
    settle_launches()
    assert ops.admm_chunk.launches.get(CLUSTER_BOX, 0) >= 30
    # a frame a launch, and one more for the first frame's capture of the
    # jitted extractor (its eager warm-up)
    assert chain_edges.launches.get(TRACK_CHAIN_EDGES, 0) == 30 + 1
    assert sim.distance > 20.0


@pytest.mark.cuda
def test_tsp_tour_builds_on_the_card_machine(cuda_device):
    from acmpc_tpu_torch import native

    rng = np.random.default_rng(1)
    theta = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    loop = np.stack([100 * np.cos(theta), 80 * np.sin(theta)], axis=1) + rng.normal(scale=0.3, size=(200, 2))
    points = np.float32(loop[rng.permutation(200)])
    order = native.tsp_tour(points, 3.0)
    np.testing.assert_array_equal(order, native._tsp_tour_numpy(points, 3.0))


def _raceline_inputs():
    """monza at the raceline CLI's cap (586 points) and its half widths."""
    from acmpc_tpu_torch.cli import raceline as cli
    from acmpc_tpu_torch.localise.track_map import load_track_map

    tm = load_track_map(ROOT / "data" / "maps" / "monza.npz", device="cpu")
    centre, left = tm.centre.numpy(), tm.left.numpy()
    return cli.corridor(centre, left, cli.cap_stride(len(centre)))


@pytest.mark.cuda
def test_raceline_on_card_matches_cpu_through_the_split_kernel(cuda_device):
    # since the box block the 586-point raceline's chunks run in a
    # cluster; the split kernel takes the 1,953-point one
    # (test_box_split_matches_both_references_on_card)
    from acmpc_tpu_torch.utils.raceline import offset_curvature, solve_raceline

    centre, half = _raceline_inputs()
    admm_chunk.launches.clear()
    card = solve_raceline(centre, half, device=cuda_device)
    launches = dict(admm_chunk.launches)
    cpu = solve_raceline(centre, half, device="cpu")
    iterations = sum(int(s.iterations) for s in card.solutions)
    assert launches == {CLUSTER_BOX: iterations // 25}
    assert all(bool(s.solved) for s in card.solutions)
    a, b = card.alpha.cpu().numpy(), cpu.alpha.numpy()
    # what the QPs' stopping rule fixes (tests/test_torch_raceline.py):
    # the curvature profile and its squared sum, alpha within the margin
    c = torch.tensor(centre, dtype=torch.float32)

    def kappa(alpha):
        return offset_curvature(c, torch.tensor(alpha)).numpy()

    assert np.abs(kappa(a) - kappa(b)).max() <= 0.1 * np.abs(kappa(b)).max()
    assert float((kappa(a) ** 2).sum()) == pytest.approx(float((kappa(b) ** 2).sum()), rel=5e-3)
    np.testing.assert_allclose(a, b, atol=1.0, rtol=0)
    bound = np.maximum(half - 1.0, 0.0)
    assert np.max(np.abs(a) - bound) <= max(0.0, np.max(np.abs(b) - bound)) + 1e-3


@pytest.mark.cuda
def test_render_panels_takes_cuda_tensors(cuda_device):
    from acmpc_tpu_torch.dashboard.server import FEED_NAMES, Dashboard
    from acmpc_tpu_torch.localise.localiser import Localiser
    from acmpc_tpu_torch.config import load_config

    agent = type("FakeAgent", (), {})()
    agent._latest_frames = {
        "camera": torch.randint(0, 256, (736, 1280, 3), dtype=torch.uint8, device=cuda_device),
        "segmentation": torch.rand(736, 1280, device=cuda_device) > 0.5,
        "semantics": torch.randint(0, 10, (736, 1280), device=cuda_device),
    }
    agent._latest_tracks = {"centre": np.stack([np.zeros(10), np.arange(10.0)], 1)}
    agent._latest_state = {}
    agent.controller = type("C", (), {"predicted_locations": np.zeros((20, 2))})()
    cfg = load_config(ROOT / "configs" / "monza.yaml")
    agent.localiser = Localiser(cfg.localisation, str(ROOT / cfg.map_path), device=cuda_device)
    dash = Dashboard(agent, None, port=0)
    dash._attach("composite", +1)
    panels = dash._render_panels()
    assert set(panels) == set(FEED_NAMES)
    assert all(isinstance(p, np.ndarray) and p.dtype == np.uint8 for p in panels.values())
    assert panels["camera"].shape == (736, 1280, 3) and panels["semantics"].shape == (736, 1280, 3)
    dash.render_once()
    assert dash.render_errors == 0
    for name in (*FEED_NAMES, "composite"):
        frame = dash._frame(name)
        assert frame[:2] == b"\xff\xd8" and frame[-2:] == b"\xff\xd9", name


@pytest.mark.cuda
def test_pacejka_on_card_matches_cpu(cuda_device):
    from acmpc_tpu_torch.dynamics import pacejka

    for data in (pacejka.ACCELERATION_DATA, pacejka.BRAKING_DATA):
        np.testing.assert_allclose(
            pacejka.fit_long_force(data, device=cuda_device),
            pacejka.fit_long_force(data, device="cpu"), rtol=1e-4, atol=1e-5,
        )
    card = pacejka.DynamicBicycleModel(device=cuda_device)
    cpu = pacejka.DynamicBicycleModel(device="cpu")
    state = np.array([0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    controls = np.tile(np.array([0.1, 1.0]), (40, 1))
    got = card.rollout(state, controls)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), cpu.rollout(state, controls).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_sharded_get_control_nccl_world_of_one_on_card(cuda_device):
    """An NCCL process group of one rank on the card: the sharded step is
    the fused batched step, and the fleet reductions run through NCCL."""
    import torch.distributed as dist

    from acmpc_tpu_torch.cli.launch_pod import racing_mpc
    from acmpc_tpu_torch.geometry.tracks import get_curved_track, with_widths
    from acmpc_tpu_torch.parallel import make_mesh, sharded_get_control
    from acmpc_tpu_torch.parallel.multihost import start_process_group

    mpc = racing_mpc(cuda_device, rti=None)
    refs = torch.as_tensor(np.stack([
        with_widths(get_curved_track(c, 50, angle=-np.pi / 2)) for c in np.linspace(5e-4, 0.02, 8)
    ]).astype(np.float32), device=cuda_device)
    want, _ = mpc.batched_get_control_fused(mpc.initial_state(8), refs)
    start_process_group(None, 1, 0, device=cuda_device, backend="nccl")
    try:
        mesh = make_mesh(device=cuda_device)
        assert mesh.backend == "nccl" and mesh.size == 1
        got, fleet = sharded_get_control(mpc, mesh)(mpc.initial_state(8), refs)
        assert int(fleet["n_solved"]) == 8
        assert float(fleet["worst_r_prim"]) >= 0.0
        assert dict(mesh.calls) == {"psum": 1, "pmax": 2}
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(got.projected_control, want.projected_control, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_tridiag_solve_and_spd_inverse_on_card_match_cpu(cuda_device):
    """PCR at a map's size and the block-Schur inverse at the horizon-50
    KKT size, on the card against the CPU: the same fp32 steps (PCR is
    elementwise; the inverse's matmuls differ in summation order, so
    its residual is held and the two agree to 1e-4 of their scale)."""
    from acmpc_tpu_torch.bench.pod_sweep import spike_system
    from acmpc_tpu_torch.ops import spd_inverse, tridiag_solve

    parts = [torch.as_tensor(a) for a in spike_system()]
    cpu = tridiag_solve(*parts)
    card = tridiag_solve(*(p.to(cuda_device) for p in parts))
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=1e-6)

    rng = np.random.default_rng(0)
    n = 248
    M = rng.normal(size=(4, n, n)).astype(np.float32)
    K = torch.as_tensor(M @ np.swapaxes(M, -1, -2) + n * np.eye(n, dtype=np.float32))
    cpu = spd_inverse(K)
    card = spd_inverse(K.to(cuda_device))
    eye = torch.eye(n, device=cuda_device)
    assert float((eye - K.to(cuda_device) @ card).abs().max()) < 1e-3
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-4 * float(cpu.abs().max()))


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One training step at the tool's frame size, batch 2, from the same
    variables: the loss, every leaf's gradient (the BatchNorm statistics
    included) and every leaf after the AdamW step, with
    bench/train_step.py's tolerances and its card-against-CPU gradient
    tolerance."""
    from acmpc_tpu_torch.bench import train_step as bench
    from acmpc_tpu_torch.cli import train_segmenter as ts

    variables = ts.init_variables(0)
    images, masks = ts.sample_frames(*ts.make_sim(0), 2)
    records = {}
    for device in ("cpu", cuda_device):
        model = ts.make_model(variables, device)
        opt = ts.make_optimizer(model, ts.LR)
        records[str(device)] = bench.step_record(
            model, opt, torch.as_tensor(images, device=device), torch.as_tensor(masks, device=device)
        )
    errors = bench.compare_records(records["cuda"], records["cpu"], ts.LR, bench.CARD_GRAD_RTOL)
    assert errors["fails"] == [], errors
    assert float(records["cuda"]["grads"]["encoder.bn1.running_var"].abs().max()) > 0


@pytest.mark.cuda
def test_batchnorm_gradient_path_on_card_matches_cpu(cuda_device):
    """BatchNorm with its statistics requiring grad (Flax's explicit
    form) on the card against the CPU: the output and the gradients of
    scale, bias, mean, var and the input; without grad on the statistics
    the card runs F.batch_norm, and the two forms agree."""
    from acmpc_tpu_torch.models.fpn_resnet18 import BN_EPS, BatchNorm

    gen = torch.Generator().manual_seed(0)
    c = 64
    x = torch.randn(2, c, 16, 16, generator=gen)
    w = torch.randn(2, c, 16, 16, generator=gen)
    state = {
        "weight": 1.0 + 0.2 * torch.randn(c, generator=gen),
        "bias": 0.2 * torch.randn(c, generator=gen),
        "running_mean": 0.5 * torch.randn(c, generator=gen),
        "running_var": 0.2 + 1.8 * torch.rand(c, generator=gen),
    }
    out = {}
    for device in ("cpu", cuda_device):
        bn = BatchNorm(c)
        bn.load_state_dict(state)
        bn = bn.to(device)
        with torch.no_grad():
            plain = bn(x.to(device))
        bn.running_mean.requires_grad_(True)
        bn.running_var.requires_grad_(True)
        xd = x.to(device).detach().requires_grad_(True)
        y = bn(xd)
        torch.testing.assert_close(y.detach(), plain, rtol=0, atol=1e-5)
        want = torch.nn.functional.batch_norm(
            x.to(device), state["running_mean"].to(device), state["running_var"].to(device),
            state["weight"].to(device), state["bias"].to(device), training=False, eps=BN_EPS,
        )
        assert torch.equal(plain, want)
        (y * w.to(device)).sum().backward()
        out[str(device)] = [y.detach(), bn.weight.grad, bn.bias.grad, bn.running_mean.grad, bn.running_var.grad, xd.grad]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


# -- the compiled entries (ops/graph_loop.py) ---------------------------------


def _racing_step_inputs(device):
    from acmpc_tpu_torch.bench import batch_sweep
    from acmpc_tpu_torch.bench.graph_entries import make_mpc

    mpc = make_mpc("racing", device)
    args = (
        torch.as_tensor(batch_sweep.mixed_refs(50, 1)[0], device=device),
        torch.full((), 28.0, device=device),
        torch.zeros((), dtype=torch.bool, device=device),
        torch.zeros((), device=device),
    )
    return mpc, args


@pytest.mark.cuda
def test_jitted_get_control_replays_equal_eager_on_card(cuda_device):
    """From a carried state: the capture's call, then two replays in a
    row, each bit-equal to the eager step; what a call returned is not
    overwritten by the next replay."""
    mpc, args = _racing_step_inputs(cuda_device)
    state, _ = mpc.get_control(mpc.initial_state(), *args)
    eager = jitted = state
    kept = []
    for _ in range(3):
        eager, eager_diags = mpc.get_control(eager, *args)
        jitted, diags = mpc.jitted_get_control(jitted, *args)
        got = dataclasses.astuple(jitted) + dataclasses.astuple(diags)
        want = dataclasses.astuple(eager) + dataclasses.astuple(eager_diags)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        kept.append((jitted.qp_x, jitted.qp_x.clone()))
    for held, copy in kept:
        assert torch.equal(held, copy)
    assert len(mpc.jitted_get_control.graphs.graphs) == 1


@pytest.mark.cuda
def test_capture_that_reads_the_card_raises(cuda_device):
    from acmpc_tpu_torch.ops import graph_loop

    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError, match="capturing"):
        graph_loop.CapturedGraph(lambda t: [t * t.sum().item()], [x], "a read")
    # the stream is usable after the failed capture
    assert torch.equal(x + 1, torch.full((4,), 2.0, device=cuda_device))


@pytest.mark.cuda
def test_replay_makes_no_synchronisation(cuda_device):
    mpc, args = _racing_step_inputs(cuda_device)
    state, _ = mpc.jitted_get_control(mpc.initial_state(), *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, diags = mpc.jitted_get_control(state, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(state.solved) and int(diags.control_iterations) > 0


@pytest.mark.cuda
def test_device_while_counts_its_trips_on_card(cuda_device):
    from acmpc_tpu_torch.bench.graph_entries import loop_row

    row = loop_row(trips=100, device=cuda_device)
    assert row["max_abs_err"] == 0 and row["launches"] == 101


# -- the monitor's device spans in captured graphs (utils/monitor.py) ---------


@pytest.fixture
def monitor_on():
    """The process's monitor on for one test, off and empty after it."""
    from acmpc_tpu_torch.utils.monitor import MONITOR

    MONITOR.clear()
    MONITOR.enable()
    try:
        yield MONITOR
    finally:
        MONITOR.disable()
        MONITOR.clear()


def _timed_replays(monitor, call, n):
    """``call()`` n times, each synchronised; returns each call's wall (ms)
    and what the monitor took after them."""
    import time

    monitor.clear()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with monitor.span("test.request"):
            call()
            torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return walls, monitor.take()


def _check_samples(taken, names, walls):
    """One positive sample of each name a replay, each inside its
    replay's wall, all resolved, and no capture among the replays."""
    requests = sorted({s[4] for s in taken["spans"] if s[0] == "test.request"})
    assert len(requests) == len(walls)
    assert taken["unresolved"] == 0
    assert not any(k.startswith("graph.capture:") for k in taken["counters"])
    for name in names:
        got = {r: ms for n, r, ms in taken["device"] if n == name}
        assert len([1 for n, _, _ in taken["device"] if n == name]) == len(walls), name
        assert sorted(got) == requests, name
        for request, wall in zip(requests, walls):
            assert 0 < got[request] <= wall, (name, got[request], wall)


@pytest.mark.cuda
def test_monitor_times_the_captured_step_once_a_replay(cuda_device, monitor_on):
    """Closed loop through the captured horizon-50 step with the monitor
    on: the device spans in the graph resolve one sample each a replay,
    none left unresolved, and the answers equal the graph captured with
    the monitor off, bit for bit."""
    mpc, args = _racing_step_inputs(cuda_device)
    monitor_on.disable()
    off, _ = mpc.jitted_get_control(mpc.initial_state(), *args)
    monitor_on.enable()
    on, _ = mpc.jitted_get_control(mpc.initial_state(), *args)
    assert len(mpc.jitted_get_control.graphs.graphs) == 2
    for a, b in zip(dataclasses.astuple(on), dataclasses.astuple(off)):
        assert torch.equal(a, b)
    state = [on]

    def step():
        state[0], _ = mpc.jitted_get_control(state[0], *args)

    walls, taken = _timed_replays(monitor_on, step, 5)
    _check_samples(taken, ("mpc.prepare", "qp.factor", "qp.iterate", "mpc.extract"), walls)
    assert taken["counters"] == {"graph.replay:SpatialMPC.get_control": 5}
    names = {s[0] for s in taken["spans"]}
    assert {"graph.inputs", "graph.replay", "graph.outputs"} <= names
    # the same carried states through the graph captured with the monitor off
    monitor_on.disable()
    replay = on
    for _ in range(5):
        replay, _ = mpc.jitted_get_control(replay, *args)
    for a, b in zip(dataclasses.astuple(replay), dataclasses.astuple(state[0])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_monitor_times_the_perceivers_pipeline_once_a_replay(cuda_device, monitor_on):
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    cfg = loop.perception_config(320, 192, "fp32")
    centre, left, right, _ = loop.circuit()
    frame = torch.as_tensor(loop.make_sim(cfg, centre, left, right).reset()["image"], device=cuda_device)
    perc = Perceiver(cfg, device=cuda_device)
    on = perc._pipeline(frame)
    walls, taken = _timed_replays(monitor_on, lambda: perc._pipeline(frame), 4)
    _check_samples(taken, ("perceiver.segment", "perceiver.extract"), walls)
    monitor_on.disable()
    off = perc._pipeline(frame)
    assert len(perc._pipeline.graphs.graphs) == 2
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for key in on[2]:
        assert torch.equal(on[2][key], off[2][key]), key


@pytest.mark.cuda
def test_graph_captured_with_the_monitor_off_holds_no_event(cuda_device):
    from acmpc_tpu_torch.ops import graph_loop
    from acmpc_tpu_torch.utils.monitor import MONITOR

    assert not MONITOR.enabled
    pool = list(MONITOR._free)
    x = torch.ones(64, device=cuda_device)

    def fn(t):
        with MONITOR.device_span("test.square", t.device):
            return [t * t]

    graph = graph_loop.CapturedGraph(fn, [x], "square")
    assert graph._timers == []
    assert MONITOR._free == pool and MONITOR._eager == []
    assert torch.equal(graph([x + 1])[0], torch.full((64,), 4.0, device=cuda_device))
    assert MONITOR.take() == {"spans": [], "device": [], "counters": {}, "unresolved": 0}


# -- the camera frame's JPEG round trip (ops/jpeg_round_trip.py) ---------------

# each edge rule (tests/test_torch_jpeg_round_trip.py): whole MCUs; H even
# and not a multiple of 16; H and W odd; chroma at most 2 samples wide;
# W * 3 not a multiple of 16 (byte loads); the configured 1280x736
JPEG_SIZES = [(16, 16), (32, 64), (48, 80), (10, 24), (22, 40), (40, 96), (8, 8), (9, 17), (33, 31),
              (15, 131), (59, 33), (8, 3), (13, 4), (11, 1), (1, 30), (24, 150), (17, 30),
              (80, 200), (736, 1280)]


def _jpeg_frame(kind, h, w, seed):
    import cv2

    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "blurred":
        frame = cv2.GaussianBlur(frame, (7, 7), 2.0)
    return np.ascontiguousarray(frame)


def _opencv_round_trip(frame):
    import cv2

    ok, buf = cv2.imencode(".jpg", frame)
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "blurred"])
@pytest.mark.parametrize("h,w", JPEG_SIZES)
def test_jpeg_kernels_equal_reference_and_opencv_on_card(cuda_device, h, w, kind):
    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt

    frame = _jpeg_frame(kind, h, w, 1000 * h + w)
    jrt.jpeg_round_trip.launches.clear()
    got = jrt.jpeg_round_trip(torch.as_tensor(frame, device=cuda_device))
    torch.cuda.synchronize()
    assert dict(jrt.jpeg_round_trip.launches) == {jrt.BLOCKS_KERNEL: 1, jrt.COLOUR_KERNEL: 1}
    assert got.device.type == "cuda" and got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 3)
    want = jrt.jpeg_round_trip_reference(torch.from_numpy(frame))
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(got.cpu().numpy(), _opencv_round_trip(frame))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 16])
def test_jpeg_kernels_on_unaligned_frames_on_card(cuda_device, offset):
    # a frame that starts `offset` bytes into its allocation: byte loads
    # and stores where 16- and 4-byte accesses would be misaligned
    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt

    frame = _jpeg_frame("blurred", 64, 128, offset)
    flat = torch.empty(frame.size + offset, dtype=torch.uint8, device=cuda_device)
    image = flat[offset:].view(frame.shape).copy_(torch.as_tensor(frame))
    got = jrt.jpeg_round_trip(image)
    np.testing.assert_array_equal(got.cpu().numpy(), _opencv_round_trip(frame))


def _camera_cell_frame(seed):
    """One 1280x736 frame of the camera cell's renderer, on the card."""
    import json

    from perfbench import frames
    from perfbench.reference.sweep import load_centre

    config = json.loads((ROOT / "perfbench/configs/monza_racing_h50.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/camera_b1.json").read_text())
    centre = load_centre(str(ROOT / traffic["map"]))
    rng = np.random.default_rng(seed)
    rows = frames.poses(centre, rng, 1, 1, traffic["frame_step_m"], traffic["offset_amp_m"],
                        traffic["yaw_jitter_deg"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return frames.render(centre, config["agent"]["perception"], rows, traffic["half_width_m"], gen,
                         torch.device("cuda"))[0]


@pytest.mark.cuda
def test_jpeg_kernels_on_camera_frames_on_card(cuda_device):
    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt

    for seed in (2**31 + 11, 7):
        frame = _camera_cell_frame(seed)
        got = jrt.jpeg_round_trip(torch.as_tensor(frame, device=cuda_device)).cpu()
        assert torch.equal(got, jrt.jpeg_round_trip_reference(torch.from_numpy(frame)))
        np.testing.assert_array_equal(got.numpy(), _opencv_round_trip(frame))


def _sim_frame(cfg):
    from acmpc_tpu_torch.bench import perception_loop as loop

    centre, left, right, _ = loop.circuit()
    return loop.make_sim(cfg, centre, left, right).reset()["image"]


@pytest.mark.cuda
def test_perceive_on_card_equals_the_host_path(cuda_device):
    # the configured size takes the card's round trip; the host path is
    # OpenCV's round trip, the upload and the captured pipeline: the
    # pipeline sees the same bytes, so masks and tracks are equal. A
    # column-major view of the frame takes the card path too.
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.ops import jpeg_round_trip as jrt
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS

    cfg = loop.perception_config(320, 192, "fp32")
    frame = _sim_frame(cfg)
    perc = Perceiver(cfg, device=cuda_device)
    jrt.jpeg_round_trip.launches.clear()
    card = [perc.perceive(frame) for _ in range(2)][-1]
    settle_launches()
    # the capture's warm-up, its first replay, then one replay
    assert dict(jrt.jpeg_round_trip.launches) == {jrt.BLOCKS_KERNEL: 3, jrt.COLOUR_KERNEL: 3}
    view = perc.perceive(np.asfortranarray(frame))
    assert dict(jrt.jpeg_round_trip.launches) == {jrt.BLOCKS_KERNEL: 4, jrt.COLOUR_KERNEL: 4}
    drivable, semantics, tracks = perc._pipeline(torch.as_tensor(perc._encode_decode_image(frame), device=cuda_device))
    host = {"drivable": drivable, "semantics": semantics, "centreline": tracks["centre"],
            **{k: tracks[k] for k in TRACK_KEYS if k != "centre"}}
    assert len(perc._raw_pipeline.graphs.graphs) == 1 and len(perc._pipeline.graphs.graphs) == 1
    assert set(card) == set(host)
    for key in card:
        assert card[key].device.type == "cuda", key
        assert torch.equal(card[key], host[key]), key
        assert torch.equal(card[key], view[key]), key


@pytest.mark.cuda
def test_perceive_spans_and_counters_on_card(cuda_device, monitor_on):
    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    cfg = loop.perception_config(320, 192, "fp32")
    frame = _sim_frame(cfg)
    perc = Perceiver(cfg, device=cuda_device)
    monitor_on.clear()
    perc.perceive(frame)  # captures the graph, its device spans in it
    taken = monitor_on.take()
    parents = {}
    for name, _, _, parent, _ in taken["spans"]:
        parents.setdefault(name, set()).add(parent)
    assert parents["perceiver.jpeg"] == {"perceiver.pipeline"}
    assert parents["perceiver.segment"] == {"perceiver.pipeline"}
    assert not {"perceiver.jpeg_encode", "perceiver.jpeg_decode", "perceiver.resize"} & set(parents)
    assert taken["counters"]["perceiver.jpeg:device"] == 1
    assert "perceiver.jpeg:host" not in taken["counters"]
    # replays: one device sample of the round trip each, inside its request
    walls, taken = _timed_replays(monitor_on, lambda: perc.perceive(frame), 3)
    _check_samples(taken, ("perceiver.jpeg", "perceiver.segment", "perceiver.extract"), walls)
    assert taken["counters"]["perceiver.jpeg:device"] == 3
    # an off-size frame: OpenCV's round trip and the resize on the host
    monitor_on.clear()
    perc.perceive(np.ascontiguousarray(frame[:190]))
    taken = monitor_on.take()
    names = {s[0] for s in taken["spans"]}
    assert {"perceiver.jpeg_encode", "perceiver.jpeg_decode", "perceiver.resize"} <= names
    assert "perceiver.jpeg" not in names
    assert taken["counters"]["perceiver.jpeg:host"] == 1
    assert "perceiver.jpeg:device" not in taken["counters"]


def _segformer_perceiver(device):
    import dataclasses

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.models.segformer import SegformerConfig
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from perfbench.reference.segformer import SHAPE_KEYS, random_state

    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="segformer_b2", model_path=None)
    shape = {k: getattr(SegformerConfig(), k) for k in SHAPE_KEYS}
    variables = random_state(2**31 + 20, shape)
    return cfg, shape, variables, Perceiver(cfg, variables, device=device, keep_logits=True)


@pytest.mark.cuda
def test_segformer_forward_matches_the_reference_on_card(cuda_device):
    # 1280x736 in bf16 against the plain float32 reference on the frame's
    # round trip, at stage 1's grid, within the benchmark cell's limit
    # (PERF.md: the readings it was set from)
    import json

    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from perfbench.reference.segformer import SegFormer

    limit = json.loads((ROOT / "perfbench" / "traffic" / "perceive_b1.json").read_text())["logit_gap_limit"]
    cfg, shape, variables, perc = _segformer_perceiver(cuda_device)
    frame = torch.as_tensor(_sim_frame(cfg), device=cuda_device)
    got = perc._raw_pipeline(frame).logits
    want = SegFormer(variables, shape, cuda_device).coarse_logits(jpeg_round_trip_reference(frame))
    assert got.shape == (1, 184, 320, 10) and got.dtype == torch.bfloat16
    gap = float((got[0].permute(2, 0, 1).double() - want.double()).abs().max() / want.abs().max())
    assert gap <= limit


@pytest.mark.cuda
def test_segformer_graph_equals_eager_on_card(cuda_device):
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS

    cfg, _, _, perc = _segformer_perceiver(cuda_device)
    frame = torch.as_tensor(_sim_frame(cfg), device=cuda_device)
    for _ in range(2):  # the capture, then a replay
        graph = perc._raw_pipeline(frame)
    eager = perc._run_pipeline(jpeg_round_trip_reference(frame))
    assert torch.equal(graph.logits, eager.logits)
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1], eager[1])
    for k in TRACK_KEYS:
        assert torch.equal(graph[2][k], eager[2][k]), k


# -- SegFormer's head resample (ops/segformer_resample.py)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("frame", [(736, 1280), (384, 640)], ids=["1280x736", "640x384"])
def test_segformer_resample_kernel_equals_the_plain_version_on_card(cuda_device, frame, n, dtype):
    # the kernel forms PyTorch's resize weights and blend in float32 and
    # rounds once, as upsample_bilinear2d does: bit-equal is expected, one
    # unit in the last place the most allowed
    from acmpc_tpu_torch.bench.segformer_head import compare, head_parts
    from acmpc_tpu_torch.ops import segformer_resample as op

    parts = head_parts(n, *frame, dtype, cuda_device, seed=n)
    size = parts[0].shape[-2:]
    before = op.segformer_resample.launches[op.KERNEL]
    got = op.segformer_resample(parts, size)
    torch.cuda.synchronize()
    assert op.segformer_resample.launches[op.KERNEL] == before + 1
    want = op.segformer_resample_reference(parts, size)
    assert got.shape == want.shape == (n, 4 * op.CHANNELS, frame[0] // 4, frame[1] // 4)
    assert got.dtype == dtype and got.stride() == want.stride()
    assert compare(got, want)["max_ulps"] <= 1


@pytest.mark.cuda
def test_segformer_head_resamples_in_one_launch_a_frame_on_card(cuda_device):
    # each replay runs the kernel once (its output against eager:
    # test_segformer_graph_equals_eager_on_card)
    from acmpc_tpu_torch.ops import segformer_resample as op

    cfg, _, _, perc = _segformer_perceiver(cuda_device)
    frame = torch.as_tensor(_sim_frame(cfg), device=cuda_device)
    perc._raw_pipeline(frame)  # the capture
    settle_launches()
    op.segformer_resample.launches.clear()
    for _ in range(4):
        perc._raw_pipeline(frame)
    settle_launches()
    assert op.segformer_resample.launches[op.KERNEL] == 4


@pytest.mark.cuda
def test_segformer_perceiver_equals_its_plain_head_on_card(cuda_device, monkeypatch):
    # the perceiver through the kernel against the same perceiver with the
    # head's plain resizes and torch.cat: the fuse reads the same bits, so
    # the logits, masks and tracks are equal
    from acmpc_tpu_torch.models import segformer as sf
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.ops.segformer_resample import segformer_resample_reference
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS

    cfg, _, _, perc = _segformer_perceiver(cuda_device)
    image = jpeg_round_trip_reference(torch.as_tensor(_sim_frame(cfg), device=cuda_device))
    got = perc._run_pipeline(image)
    monkeypatch.setattr(sf, "segformer_resample", segformer_resample_reference)
    want = perc._run_pipeline(image)
    assert torch.equal(got.logits, want.logits)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in TRACK_KEYS:
        assert torch.equal(got[2][k], want[2][k]), k


# -- Mask2Former-R50 and ms_deform_attn (models/mask2former.py, ops/ms_deform_attn.py)

# the published pixel decoder's three levels at 1280x736 (1/32, 1/16, 1/8)
M2F_SHAPES = [(23, 40), (46, 80), (92, 160)]


def _deform_inputs(device, seed=7):
    """bf16 value, offsets and logits of one layer at the published shapes
    (19,320 queries, 8 heads of 32, 3 levels, 4 points): offsets of a few
    cells, some whole numbers (pixel centres, up to the reference
    points' rounding) and some far outside the map."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = sum(h * w for h, w in M2F_SHAPES)
    value = torch.randn(1, S, 256, device=device, generator=g).bfloat16()
    offsets = torch.randn(1, S, 192, device=device, generator=g) * 3
    offsets[0, ::7, ::3] = torch.round(offsets[0, ::7, ::3])
    offsets[0, ::11, ::5] *= 40
    logits = torch.randn(1, S, 96, device=device, generator=g).bfloat16()
    return value, offsets.bfloat16(), logits


@pytest.mark.cuda
def test_ms_deform_attn_kernel_matches_its_twin_at_the_published_shapes(cuda_device):
    # the kernel and the plain version form the same float32 locations and
    # weights and sum the same taps in float32 in another order: the bf16
    # outputs differ by at most one rounding of the larger (2^-7 of it),
    # or by float32 sums' rounding where the taps cancel near zero
    from acmpc_tpu_torch.ops import ms_deform_attn as op

    value, offsets, logits = _deform_inputs(cuda_device)
    before = op.ms_deform_attn.launches[op.KERNEL]
    got = op.ms_deform_attn(value, offsets, logits, M2F_SHAPES)
    torch.cuda.synchronize()
    assert op.ms_deform_attn.launches[op.KERNEL] == before + 1
    want = op.ms_deform_attn_reference(value, offsets, logits, M2F_SHAPES)
    assert got.shape == want.shape == value.shape and got.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + 1e-5 * w.abs().max()).all())


def _m2f_perceiver(device):
    import json

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from perfbench.drivers.perceive import asphalt
    from perfbench.reference.mask2former import fit_heads, random_state

    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_r50.json").read_text())
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="mask2former_r50",
                              model_path=None)
    centre, left, right, _ = loop.circuit()
    host, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, 3)
    frames = [torch.as_tensor(f, device=device) for f in host]
    fit = [jpeg_round_trip_reference(f).cpu().numpy() for f in frames[:2]]
    variables = fit_heads(random_state(2**31 + 24, shape), shape, fit, [asphalt(i) for i in fit], device)
    return shape, variables, frames, Perceiver(cfg, variables, device=device, keep_logits=True)


@pytest.mark.cuda
def test_mask2former_graph_replays_equal_eager_on_card(cuda_device):
    from acmpc_tpu_torch.ops import ms_deform_attn as op
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.tracks import TRACK_KEYS

    _, _, frames, perc = _m2f_perceiver(cuda_device)
    eager = perc._run_pipeline(jpeg_round_trip_reference(frames[2]))
    for _ in range(3):  # the capture, then two replays
        graph = perc._raw_pipeline(frames[2])
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1], eager[1])
    assert len(graph.logits) == len(eager.logits) == 3 + 9
    assert all(torch.equal(a, b) for a, b in zip(graph.logits, eager.logits))
    for k in TRACK_KEYS:
        assert torch.equal(graph[2][k], eager[2][k]), k
    # six deformable layers: six launches a frame, each replay too
    settle_launches()
    op.ms_deform_attn.launches.clear()
    for _ in range(4):
        perc._raw_pipeline(frames[1])
    settle_launches()
    assert op.ms_deform_attn.launches[op.KERNEL] == 6 * 4


@pytest.mark.cuda
def test_mask2former_matches_the_reference_on_card(cuda_device):
    # 1280x736 in bf16 against the plain float32 reference on the frame's
    # round trip, fed the program's attention masks, within the benchmark
    # cell's limits (PERF.md: the readings they were set from)
    import json

    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from perfbench.reference.mask2former import Mask2Former

    limits = json.loads((ROOT / "perfbench" / "traffic" / "perceive_m2f_b1.json").read_text())
    shape, variables, frames, perc = _m2f_perceiver(cuda_device)
    cls, mask, memory, *masks = perc._raw_pipeline(frames[2]).logits
    assert cls.shape == (1, 100, 11) and mask.shape == (1, 100, 184, 320) and memory.shape == (1, 19_320, 256)
    want = Mask2Former(variables, shape, cuda_device).forward(jpeg_round_trip_reference(frames[2]),
                                                              [m[0] for m in masks])

    def gap(got, ref):
        return float((got.double() - ref.double()).abs().max() / ref.abs().max())

    assert gap(cls[0], want["class_logits"]) <= limits["class_gap_limit"]
    assert gap(mask[0], want["mask_logits"]) <= limits["mask_logit_gap_limit"]
    assert gap(memory[0], want["memory"]) <= limits["encoder_gap_limit"]


# -- Swin's shifted-window attention (ops/window_attention.py, models/swin.py)

# Swin-L's four stages at 1280x736 (grid, channels, heads), window 12, and
# a window of 7 on grids that pad
SWIN_L_STAGES = [((184, 320), 192, 6), ((92, 160), 384, 12), ((46, 80), 768, 24), ((23, 40), 1536, 48)]
WINDOW_CASES = [(grid, c, h, 12, shift) for grid, c, h in SWIN_L_STAGES for shift in (0, 6)] + [
    ((40, 56), 64, 2, 7, shift) for shift in (0, 3)] + [((9, 16), 128, 4, 7, 3)]


def _window_inputs(grid, c, heads, window, dtype, device, seed=5):
    """qkv of N(0, 2^2) (scores of a few units: a peaked softmax), a bias
    and a table of N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = 2.0 * torch.randn((1, *grid, 3 * c), device=device, generator=g)
    bias = torch.randn(3 * c, device=device, generator=g)
    table = torch.randn(((2 * window - 1) ** 2, heads), device=device, generator=g)
    return qkv.to(dtype), bias.to(dtype), table.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=[f"{g[0]}x{g[1]}_c{c}_w{w}_s{s}" for g, c, _, w, s in WINDOW_CASES])
def test_window_attention_kernel_matches_the_plain_version_on_card(cuda_device, case, dtype):
    # bf16: the kernel keeps the scores and the softmax in float32 where
    # the plain composition rounds q / sqrt(32), the scores, the bias's
    # sum and the probabilities to bf16; both round P to bf16 for P V. So
    # against the exact attention (float64 of the same inputs) the kernel
    # is no further than the plain version, up to one rounding of the
    # output (2^-8 of the largest). float32: the same sums in another
    # order: 1e-5 of the largest output
    from acmpc_tpu_torch.ops import window_attention as op

    grid, c, heads, window, shift = case
    qkv, bias, table = _window_inputs(grid, c, heads, window, dtype, cuda_device)
    name = op.KERNEL if dtype == torch.bfloat16 else op.KERNEL_F32
    before = op.window_attention.launches[name]
    got = op.window_attention(qkv, bias, table, heads, window, shift)
    torch.cuda.synchronize()
    assert op.window_attention.launches[name] == before + 1
    want = op.window_attention_reference(qkv, bias, table, heads, window, shift)
    assert got.shape == want.shape == (1, *grid, c) and got.dtype == dtype
    exact = op.window_attention_reference(qkv.double(), bias.double(), table.double(), heads, window, shift)
    scale = float(exact.abs().max())
    if dtype == torch.bfloat16:
        kernel_err = float((got.double() - exact).abs().max())
        plain_err = float((want.double() - exact).abs().max())
        assert kernel_err <= plain_err + 2.0 ** -8 * scale, (kernel_err, plain_err, scale)
    else:
        assert float((got.double() - want.double()).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_window_attention_wrapper_refuses_what_the_kernel_does_not_take_on_card(cuda_device):
    from acmpc_tpu_torch.ops import window_attention as op

    qkv, bias, table = _window_inputs((23, 40), 192, 6, 12, torch.bfloat16, cuda_device)
    before = sum(op.window_attention.launches.values())
    with pytest.raises(ValueError, match="heads of 32"):
        op.window_attention(qkv, bias, table[:, :3], 3, 12, 0)  # heads of 64
    with pytest.raises(ValueError, match="windows up to 12"):
        op.window_attention(qkv, bias, torch.zeros((25 * 25, 6), dtype=qkv.dtype, device=cuda_device), 6, 13, 0)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        op.window_attention(qkv.half(), bias.half(), table.half(), 6, 12, 6)
    assert sum(op.window_attention.launches.values()) == before


@pytest.mark.cuda
def test_swin_counts_one_launch_a_block_on_card(cuda_device):
    from acmpc_tpu_torch.models import swin as S
    from acmpc_tpu_torch.ops import window_attention as op

    cfg = S.SwinConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=7)
    model = S.SwinTransformer(cfg).to(cuda_device, torch.bfloat16, memory_format=torch.channels_last).eval()
    x = torch.randn((1, 3, 160, 224), device=cuda_device).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    before = op.window_attention.launches[op.KERNEL]
    with torch.no_grad():
        feats = model(x)
    torch.cuda.synchronize()
    assert op.window_attention.launches[op.KERNEL] == before + 8
    assert [tuple(f.shape) for f in feats] == [(1, 32, 40, 56), (1, 64, 20, 28), (1, 128, 10, 14), (1, 256, 5, 7)]


def _swin_perceiver(device):
    import json

    from acmpc_tpu_torch.bench import perception_loop as loop
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from acmpc_tpu_torch.perception.perceiver import Perceiver
    from perfbench.drivers.perceive import asphalt
    from perfbench.reference.swin import fit_heads, random_state

    shape = json.loads((ROOT / "perfbench" / "configs" / "monza_racing_mask2former_swin_l.json").read_text())
    cfg = dataclasses.replace(loop.perception_config(precision="bf16"), architecture="mask2former_swin_l",
                              model_path=None)
    centre, left, right, _ = loop.circuit()
    host, _ = loop.sim_frames(loop.make_sim(cfg, centre, left, right), centre, 3)
    frames = [torch.as_tensor(f, device=device) for f in host]
    fit = [jpeg_round_trip_reference(f).cpu().numpy() for f in frames[:2]]
    variables = fit_heads(random_state(2**31 + 26, shape), shape, fit, [asphalt(i) for i in fit], device)
    return shape, variables, frames, Perceiver(cfg, variables, device=device, keep_logits=True)


@pytest.mark.cuda
def test_mask2former_swin_graph_and_reference_on_card(cuda_device):
    # the captured pipeline bit-equal to eager, 24 window-attention and 6
    # deformable launches a replay; 1280x736 in bf16 against the plain
    # float32 reference on the frame's round trip, fed the program's
    # attention masks, within the benchmark cell's limits (PERF.md: the
    # readings they were set from)
    import json

    from acmpc_tpu_torch.ops import ms_deform_attn as deform
    from acmpc_tpu_torch.ops import window_attention as op
    from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip_reference
    from perfbench.reference.swin import Mask2Former

    limits = json.loads((ROOT / "perfbench" / "traffic" / "perceive_swin_b1.json").read_text())
    shape, variables, frames, perc = _swin_perceiver(cuda_device)
    eager = perc._run_pipeline(jpeg_round_trip_reference(frames[2]))
    for _ in range(3):  # the capture, then two replays
        graph = perc._raw_pipeline(frames[2])
    assert len(graph.logits) == len(eager.logits) == 3 + 9 + 4
    assert all(torch.equal(a, b) for a, b in zip(graph.logits, eager.logits))
    assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1], eager[1])
    settle_launches()
    op.window_attention.launches.clear()
    deform.ms_deform_attn.launches.clear()
    for _ in range(2):
        perc._raw_pipeline(frames[1])
    settle_launches()
    assert op.window_attention.launches[op.KERNEL] == 24 * 2
    assert deform.ms_deform_attn.launches[deform.KERNEL] == 6 * 2
    cls, mask, memory, *rest = graph.logits
    masks, feats = rest[:9], rest[9:]
    ref = Mask2Former(variables, shape, cuda_device)
    image = jpeg_round_trip_reference(frames[2])
    want = ref.forward(image, [m[0] for m in masks])

    def gap(got, reference):
        return float((got.double() - reference.double()).abs().max() / reference.abs().max())

    assert gap(cls[0], want["class_logits"]) <= limits["class_gap_limit"]
    assert gap(mask[0], want["mask_logits"]) <= limits["mask_logit_gap_limit"]
    assert gap(memory[0], want["memory"]) <= limits["encoder_gap_limit"]
    assert max(gap(f[0], r) for f, r in zip(feats, ref.backbone_maps(image))) <= limits["backbone_gap_limit"]


# -- Ruiz equilibration (ops/ruiz.py) -----------------------------------------

# the kernel against the plain version: every product, square root and
# division of the passes rounds as the plain version's and maxima are
# exact, but the mean over n sums in another order than PyTorch's CUDA
# reduction and divides by n where PyTorch multiplies by a rounded 1 / n
# (an ulp or two of a pass's g), which ten passes compound: 1e-5 relative
# on every output
RUIZ_RTOL = 1e-5


def _assert_ruiz_matches(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=RUIZ_RTOL, atol=0)


def _control_qp(mode, batch, device):
    """(P, q, A) of monza's racing control (horizon 50) or its mapping
    control (horizon 100) on ``batch`` windows of ``mixed_refs``."""
    from acmpc_tpu_torch.bench import batch_sweep
    from acmpc_tpu_torch.bench.graph_entries import make_mpc

    mpc = make_mpc(mode, device)
    refs = torch.as_tensor(batch_sweep.mixed_refs(mpc.horizon, batch), device=device)

    def full(v, dtype=torch.float32):
        return torch.full((batch,), v, dtype=dtype, device=device)

    _, _, qp = mpc._prepare(
        mpc.initial_state(batch), refs, full(mpc.config.constraints.v_max), full(False, torch.bool), full(0.0)
    )
    return qp[:3]


def _raceline_qp(stride, device):
    """monza's raceline QP at its first re-linearisation: 586 points at
    the CLI's cap (``stride`` None), 1,953 at stride 6."""
    from acmpc_tpu_torch.cli import raceline as cli
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.utils.raceline import _unit_normals, raceline_qp

    tm = load_track_map(ROOT / "data" / "maps" / "monza.npz", device="cpu")
    centre, left = tm.centre.numpy(), tm.left.numpy()
    centre, half = cli.corridor(centre, left, stride or cli.cap_stride(len(centre)))
    c = torch.tensor(centre, dtype=torch.float32, device=device)
    bound = torch.clamp(torch.tensor(half, dtype=torch.float32, device=device) - 1.0, min=0.0)
    return raceline_qp(c, _unit_normals(c), bound, torch.zeros(len(c), device=device))[:3]


def _ruiz_once(P, q, A, n_iters):
    """The wrapper's outputs and the launches it counted."""
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate

    ruiz_equilibrate.launches.clear()
    out = ruiz_equilibrate(P, q, A, n_iters)
    torch.cuda.synchronize()
    return out, dict(ruiz_equilibrate.launches)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode, batch", [("racing", 1), ("racing", 32), ("racing", 256), ("mapping", 1), ("mapping", 8)]
)
@pytest.mark.parametrize("n_iters", [5, 10])
def test_ruiz_kernel_matches_plain_on_control_qps_on_card(cuda_device, mode, batch, n_iters):
    from acmpc_tpu_torch.ops.ruiz import kernel_name, plan_ruiz, ruiz_equilibrate_reference

    P, q, A = _control_qp(mode, batch, cuda_device)
    got, launches = _ruiz_once(P, q, A, n_iters)
    assert launches == {kernel_name(plan_ruiz(q.shape[-1], A.shape[-2], batch)): 1}
    _assert_ruiz_matches(got, ruiz_equilibrate_reference(P, q, A, n_iters))


@pytest.mark.cuda
@pytest.mark.parametrize("stride, variant", [(None, "resident"), (6, "streamed")])
def test_ruiz_kernel_matches_plain_on_raceline_qps_on_card(cuda_device, stride, variant):
    # 586 points: a cluster holds the lane; 1,953: the streamed plan
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate_reference

    P, q, A = _raceline_qp(stride, cuda_device)
    got, launches = _ruiz_once(P, q, A, 10)
    assert launches == {f"ruiz_equilibrate[{variant}]": 1}
    _assert_ruiz_matches(got, ruiz_equilibrate_reference(P, q, A, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["resident", "streamed"])
@pytest.mark.parametrize("n_iters", [0, 1, 2, 10])
def test_ruiz_kernel_on_dense_random_qps_on_card(cuda_device, variant, n_iters):
    # a dense A (no box block), m != n, entries over several decades; each
    # plan at every cluster size that holds it
    from acmpc_tpu_torch.ops.ruiz import _launch, ruiz_equilibrate_reference, ruiz_plan, smem_bytes

    rng = np.random.default_rng(23 + n_iters)
    n, m, batch = 37, 61, 5
    Mx = rng.normal(size=(batch, n, n)) * 10.0 ** rng.uniform(-2, 2, size=(batch, 1, n))
    P = Mx @ Mx.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    q = rng.normal(size=(batch, n)) * 10.0 ** rng.uniform(-3, 3, size=(batch, n))
    A = rng.normal(size=(batch, m, n)) * 10.0 ** rng.uniform(-2, 2, size=(batch, m, 1))
    P, q, A = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (P, q, A))
    want = ruiz_equilibrate_reference(P, q, A, n_iters)
    for C in (1, 2, 3, 8, 16):
        if variant == "resident" and smem_bytes(n, m, C, True) > 232_448:
            continue
        _assert_ruiz_matches(_launch(ruiz_plan(n, m, C, variant == "resident"), P, q, A, n_iters), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ruiz_kernel_on_unaligned_lane_bases_on_card(cuda_device, offset):
    # each tensor ``offset`` floats into its allocation: the lanes' rows
    # start off 16-byte alignment, as do the CTAs' slabs
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate_reference

    def shifted(t):
        flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        return flat[offset:].view(t.shape).copy_(t)

    P, q, A = (shifted(t) for t in _control_qp("racing", 3, cuda_device))
    assert P.data_ptr() % 16 != 0
    got, launches = _ruiz_once(P, q, A, 5)
    assert launches == {"ruiz_equilibrate[resident]": 1}
    _assert_ruiz_matches(got, ruiz_equilibrate_reference(P, q, A, 5))


@pytest.mark.cuda
def test_ruiz_kernel_on_one_qp_on_card(cuda_device):
    # one QP (no lane axis) goes as a batch of one
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate_reference

    P, q, A = (t[0] for t in _control_qp("racing", 1, cuda_device))
    got, launches = _ruiz_once(P, q, A, 5)
    assert launches == {"ruiz_equilibrate[resident]": 1}
    assert got[3].shape == () and got[0].shape == P.shape
    _assert_ruiz_matches(got, ruiz_equilibrate_reference(P, q, A, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "device"])
def test_ruiz_kernel_refuses_what_it_does_not_take_on_card(cuda_device, fault):
    from acmpc_tpu_torch.ops.ruiz import ruiz_equilibrate

    P, q, A = _control_qp("racing", 2, cuda_device)
    if fault == "dtype":
        P = P.double()
    elif fault == "contiguity":
        A = A.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "shape":
        A = A[:, :, :-1].contiguous()
    else:
        q = q.cpu()
    ruiz_equilibrate.launches.clear()
    with pytest.raises((TypeError, ValueError)):
        ruiz_equilibrate(P, q, A, 5)
    assert not ruiz_equilibrate.launches


def _golden_mpc(track, device):
    """The track's racing control cut to horizon 50 (the golden fixture's)."""
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=50)
    model = SpatialBicycleModel(
        vehicle=cfg.vehicle, min_velocity=control.constraints.v_min, max_velocity=control.constraints.v_max
    )
    return SpatialMPC(control, model, device=device)


GOLDEN_TRACKS = ("monza", "spa", "silverstone", "nordschleife", "vallelunga", "bathurst", "yas_marina")


@pytest.mark.cuda
def test_golden_windows_through_the_captured_step_take_the_kernel_on_card(cuda_device, monkeypatch):
    """The 35 golden windows through ``jitted_get_control``: one Ruiz
    launch a solve (the replays and each capture's eager warm-up), the
    same statuses and iteration counts as the same graphs on the plain
    scaling, and the fixture's gate of 5e-3."""
    import acmpc_tpu_torch.qp.admm as tadmm
    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.ops.ruiz import RESIDENT, ruiz_equilibrate, ruiz_equilibrate_reference

    golden = np.load(ROOT / "tests" / "fixtures" / "golden_controls.npz")
    windows = battery(50)

    def run():
        out = {}
        for track in GOLDEN_TRACKS:
            mpc = _golden_mpc(track, cuda_device)
            v_cap = min(30.0, mpc.config.unlocalised_max_speed or 30.0)
            for name, ref in windows.items():
                out[f"{track}/{name}"] = mpc.jitted_get_control(mpc.initial_state(), ref, v_cap)
        torch.cuda.synchronize()
        return out

    settle_launches()
    ruiz_equilibrate.launches.clear()
    kernel = run()
    settle_launches()
    assert dict(ruiz_equilibrate.launches) == {RESIDENT: len(GOLDEN_TRACKS) * (len(windows) + 1)}
    monkeypatch.setattr(tadmm, "ruiz_equilibrate", ruiz_equilibrate_reference)
    plain = run()
    settle_launches()
    assert dict(ruiz_equilibrate.launches) == {RESIDENT: len(GOLDEN_TRACKS) * (len(windows) + 1)}
    assert len(kernel) == 35
    for key, (state, diags) in kernel.items():
        p_state, p_diags = plain[key]
        assert int(diags.control_status) == int(p_diags.control_status), key
        assert int(diags.control_iterations) == int(p_diags.control_iterations), key
        assert bool(state.solved) == bool(golden[f"{key}/solved"]), key
        if bool(state.solved):
            for field in ("projected_control", "cum_time"):
                np.testing.assert_allclose(
                    getattr(state, field).cpu().numpy(), golden[f"{key}/{field}"], rtol=5e-3, atol=5e-3, err_msg=key
                )
