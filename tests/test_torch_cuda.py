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
    assert dict(admm_chunk.launches) == {CLUSTER_BOX: 10}


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


# -- perception: the chain-scan kernel and the Perceiver on the card
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
@pytest.mark.parametrize("band", [1, 4])
def test_chain_kernel_matches_plain_on_card(cuda_device, band):
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_SCAN, chain_scan, chain_scan_reference
    from acmpc_tpu_torch.perception.tracks import scan_rows

    cases = _perception_cases()
    chain_scan.launches.clear()
    for mask, bonnet in cases:
        _, rows, gap = scan_rows(torch.as_tensor(mask, device=cuda_device), bonnet, band=band)
        got = chain_scan(rows, gap)
        assert got.dtype == torch.bool and got.shape == rows.shape
        assert torch.equal(got, chain_scan_reference(rows, gap))
        assert torch.equal(got.cpu(), chain_scan(rows.cpu(), gap))
        # a uint8 view of the same rows gives the same chain
        assert torch.equal(chain_scan(rows.to(torch.uint8), gap), got)
    assert dict(chain_scan.launches) == {TRACK_CHAIN_SCAN: 2 * len(cases)}


@pytest.mark.cuda
def test_chain_kernel_gaps_and_widths_on_card(cuda_device):
    from acmpc_tpu_torch.ops.track_chain import chain_scan, chain_scan_reference

    rng = np.random.default_rng(0)
    frames = rng.random((3, 40, 1280)) < 0.6
    for r in range(38, -1, -1):  # runs that merge, split and break
        frames[:, r] |= frames[:, r + 1] & (rng.random((3, 1280)) < 0.5)
    for gap in (0, 1, 3):
        for frame in frames:
            rows = torch.as_tensor(frame, device=cuda_device)
            assert torch.equal(chain_scan(rows, gap), chain_scan_reference(rows, gap))
    # widths that leave threads without columns, and one column
    for w in (1, 7, 300, 1281):
        rows = torch.as_tensor(rng.random((12, w)) < 0.7, device=cuda_device)
        assert torch.equal(chain_scan(rows, 2), chain_scan_reference(rows, 2))


@pytest.mark.cuda
def test_chain_kernel_refuses_bad_rows_on_card(cuda_device):
    from acmpc_tpu_torch.ops import track_chain

    track_chain.chain_scan.launches.clear()
    good = torch.ones((8, 64), dtype=torch.bool, device=cuda_device)
    bad = [
        (good.cpu(), ValueError),  # the kernel's entry takes CUDA tensors only
        (good.float(), TypeError),
        (good[0], ValueError),
        (good[None].expand(2, 8, 64).contiguous(), ValueError),  # one frame only
        (good[None, None], ValueError),
        (good.T, ValueError),
    ]
    for rows, error in bad:
        with pytest.raises(error):
            track_chain._launch(rows, 1)
    for rows, error in bad[1:]:
        with pytest.raises(error):
            track_chain.chain_scan(rows, 1)
    assert sum(track_chain.chain_scan.launches.values()) == 0


@pytest.mark.cuda
def test_connected_runs_launch_the_kernel_once_on_card(cuda_device):
    # the connected runs are the fused kernel's mask; the scan kernel is
    # on no path
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges, chain_scan
    from acmpc_tpu_torch.perception.tracks import select_vehicle_connected_runs

    mask, bonnet = _perception_cases(1)[-1]
    chain_scan.launches.clear()
    chain_edges.launches.clear()
    got = select_vehicle_connected_runs(torch.as_tensor(mask, device=cuda_device), bonnet, band=4)
    want = select_vehicle_connected_runs(torch.as_tensor(mask), bonnet, band=4)
    assert dict(chain_edges.launches) == {TRACK_CHAIN_EDGES: 1}
    assert sum(chain_scan.launches.values()) == 0
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
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES, chain_edges, chain_scan
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    cfg = loop.perception_config(320, 192, "fp32")
    centre, left, right, _ = loop.circuit()
    frame = loop.make_sim(cfg, centre, left, right).reset()["image"]
    out = {}
    chain_scan.launches.clear()
    chain_edges.launches.clear()
    for device in ("cpu", cuda_device):
        perc = Perceiver(cfg, device=device)
        drivable, semantics, tracks = perc._run_pipeline(torch.as_tensor(frame, device=device))
        assert drivable.device.type == torch.device(device).type
        out[str(device)] = (drivable.cpu(), semantics.cpu(), {k: v.cpu() for k, v in tracks.items()})
    assert dict(chain_edges.launches) == {TRACK_CHAIN_EDGES: 1}
    assert sum(chain_scan.launches.values()) == 0
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
