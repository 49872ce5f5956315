"""The ADMM chunk with the box block on the CPU: the operator A_s = [A_d;
diag(g)] taken as a diagonal (``admm_chunk_box_reference``,
``qp/admm._build_operator`` with A_d) against the dense plain version on
the dense W and A of the same QP and both against the Pallas kernel
(interpret mode); the structured build against JAX's W at monza horizon
50; the plans of the structured shapes; the wrapper's refusals; and a
whole ``get_control`` on the structured path against JAX's step. The
CUDA kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acmpc_tpu.qp.admm as jadmm
import acmpc_tpu_torch.ops.admm_chunk as ops
import acmpc_tpu_torch.qp.admm as tadmm
from acmpc_tpu.ops.pallas_admm import admm_iterations_pallas
from acmpc_tpu_torch.ops.admm_chunk import (
    CLUSTER_BOX,
    CLUSTER_BOX_ACTIVE,
    KERNEL_NAMES,
    MAX_CLUSTER,
    SMEM_PER_BLOCK,
    admm_chunk,
    admm_chunk_box_reference,
    admm_chunk_reference,
    cluster_plan,
    cluster_smem_bytes,
    kernel_name,
    plan_chunk,
    split_layout,
    split_plan,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITERS, ALPHA, SIGMA = 25, 1.6, 1e-5
# The box block's arithmetic is not the dense operator's: K^-1 (sigma x +
# g w_b) against sigma K^-1 x + (K^-1 g) w_b, each product rounded in
# fp32, over 25 dependent iterations; equality rows (rho = 100) carry
# 100 times the rounding of z into y. So, as the kernels are held on the
# card (chip_smoke.py's KERNEL_RTOL): 1e-4 of the iterates' scale, the
# largest |value| of the output and at least 1. Measured here: each fp32
# form, the Pallas kernel's included, 0.4e-4 to 1.3e-4 from the fp64
# iterates in y, whose scale is 4 to 7.
SCALE_TOL = 1e-4
# layouts: the control QP's (m_d equality and coupling rows, then the
# identity over the variables) and the raceline's (the identity alone)
LAYOUTS = {"control": (20, 12), "raceline": (24, 0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _qps(batch, n, m_d, seed):
    """B scaled QPs whose A is [A_d; diag(g)] (what Ruiz scaling leaves of
    [A_d; I]) at rho 0.1 (100 on equality rows, every 5th dense row):
    the dense chunk inputs (W = [sigma K^-1 | K^-1 A'], A), the box
    block's (W_s = [K^-1 | K^-1 A_d'], A_d, g) and the shared vectors, in
    fp64 numpy and cast to fp32."""
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
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def _t(inp, *keys):
    return [torch.as_tensor(inp[k]) for k in keys]


VECS = ("c0", "rho", "l", "u", "x", "z", "y")


def _dense(inp, active=None, n_iters=ITERS):
    return admm_chunk(*_t(inp, "W", "A", *VECS), n_iters=n_iters, alpha=ALPHA, active=active)


def _box(inp, active=None, n_iters=ITERS):
    Ws, Ad, g = _t(inp, "Ws", "Ad", "g")
    return admm_chunk(
        Ws, Ad, *_t(inp, *VECS), n_iters=n_iters, alpha=ALPHA, active=active, g=g, sigma=SIGMA
    )


def _pallas(inp, active=None):
    """The JAX kernel on lane-padded dense inputs (NP = MP = 128), unpadded."""
    B, n = inp["x"].shape
    m = inp["z"].shape[1]
    NP = MP = 128
    W = np.zeros((B, NP, NP + MP), np.float32)
    W[:, :n, :n] = inp["W"][:, :, :n]
    W[:, :n, NP : NP + m] = inp["W"][:, :, n:]
    A = np.zeros((B, MP, NP), np.float32)
    A[:, :m, :n] = inp["A"]

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
    return np.asarray(xo)[:, :n], np.asarray(zo)[:, :m], np.asarray(yo)[:, :m]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("masked", [False, True])
def test_box_reference_matches_dense_and_pallas(layout, masked):
    n, m_d = LAYOUTS[layout]
    # B = 5 is odd, so the Pallas kernel tiles one scenario per grid step
    # and its per-tile flag is per scenario, as the CUDA kernels'
    inp = _qps(5, n, m_d, seed=len(layout) + masked)
    active = np.array([True, False, True, True, False]) if masked else None
    flag = None if active is None else torch.as_tensor(active)
    box, dense = _box(inp, flag), _dense(inp, flag)
    want = _pallas(inp, active)
    as64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}
    exact = admm_chunk_reference(
        *(as64[k] for k in ("W", "A", *VECS)), n_iters=ITERS, alpha=ALPHA, active=flag
    )
    for b, d, w, e in zip(box, dense, want, exact):
        tol = dict(rtol=0.0, atol=SCALE_TOL * max(1.0, float(np.abs(w).max())))
        np.testing.assert_allclose(b.numpy(), d.numpy(), **tol)
        np.testing.assert_allclose(b.numpy(), w, **tol)
        np.testing.assert_allclose(d.numpy(), w, **tol)
        np.testing.assert_allclose(b.numpy(), e.numpy(), **tol)
    # the iterates moved, box rows among them: not inputs against inputs
    assert np.abs(want[0] - inp["x"]).max() > 1e-2
    assert np.abs(want[1][:, m_d:] - inp["z"][:, m_d:]).max() > 1e-2
    if masked:
        for b, start in zip(box, (inp["x"], inp["z"], inp["y"])):
            np.testing.assert_array_equal(b.numpy()[~active], start[~active])


def test_box_reference_is_the_dense_function_in_exact_arithmetic():
    # in fp64 the two forms are one function: only rounding parts them.
    # The dense W and A made from the box block's, so that both hold the
    # same operator
    inp = _qps(2, *LAYOUTS["control"], seed=9)
    as64 = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}
    n = inp["x"].shape[1]
    Ws, g = as64["Ws"], as64["g"]
    as64["W"] = torch.cat([SIGMA * Ws[:, :, :n], Ws[:, :, n:], Ws[:, :, :n] * g[:, None, :]], dim=-1)
    as64["A"] = torch.cat([as64["Ad"], torch.diag_embed(g)], dim=1)
    dense = admm_chunk_reference(
        *(as64[k] for k in ("W", "A", *VECS)), n_iters=ITERS, alpha=ALPHA
    )
    box = admm_chunk_box_reference(
        *(as64[k] for k in ("Ws", "Ad", *VECS)), n_iters=ITERS, alpha=ALPHA,
        g=as64["g"], sigma=SIGMA,
    )
    for b, d in zip(box, dense):
        np.testing.assert_allclose(b.numpy(), d.numpy(), rtol=1e-9, atol=1e-9)


def test_dense_operator_keeps_the_dense_path():
    # n_b = 0: no g, the plain version of the dense kernels, bit for bit,
    # and the plans of the dense shapes as they were
    inp = _qps(3, *LAYOUTS["control"], seed=3)
    got = _dense(inp)
    want = admm_chunk_reference(*_t(inp, "W", "A", *VECS), n_iters=ITERS, alpha=ALPHA)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for n, m in ((248, 398), (498, 798), (586, 586), (1953, 1953)):
        for batch in (1, 8, 256):
            assert plan_chunk(n, m, batch, 0) == plan_chunk(n, m, batch)
            assert not plan_chunk(n, m, batch).box


def test_zero_iterations_and_empty_batch_with_the_box_block():
    inp = _qps(3, *LAYOUTS["raceline"], seed=4)
    got = _box(inp, torch.tensor([True, False, True]), n_iters=0)
    for g, k in zip(got, ("x", "z", "y")):
        np.testing.assert_array_equal(g.numpy(), inp[k])
    empty = {k: v[:0] for k, v in inp.items()}
    assert [tuple(o.shape) for o in _box(empty)] == [(0, 24), (0, 24), (0, 24)]


def test_cpu_box_path_counts_no_launch():
    admm_chunk.launches.clear()
    inp = _qps(3, *LAYOUTS["control"], seed=5)
    _box(inp)
    _box(inp, torch.tensor([True, False, True]))
    assert sum(admm_chunk.launches.values()) == 0
    assert {CLUSTER_BOX, CLUSTER_BOX_ACTIVE} <= set(KERNEL_NAMES)


# -- the operator build ----------------------------------------------------------


def _monza_qp(horizon=50):
    """The port's monza control QP (racing config) on the battery's curve
    window, as numpy."""
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dynamics import SpatialBicycleModel
    from acmpc_tpu_torch.geometry.tracks import battery
    from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

    cfg = load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=horizon)
    model = SpatialBicycleModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max)
    mpc = SpatialMPC(control, model, device="cpu")
    window = battery(horizon)["curve"].astype(np.float32)
    _, _, qp = mpc._prepare(mpc.initial_state(), torch.as_tensor(window), 28.0, False, 0.0)
    return mpc, window, [t.numpy() for t in qp]


def test_box_operator_matches_jax_w_at_monza_horizon50():
    _, _, (P, q, A, lo, hi) = _monza_qp()
    n = q.shape[-1]
    m_d = A.shape[-2] - n
    assert (n, m_d) == (248, 150)
    np.testing.assert_array_equal(A[m_d:], np.eye(n, dtype=np.float32))
    # JAX's W, as its solver builds it (acmpc_tpu/qp/admm.py build_operator)
    with jax.default_matmul_precision("highest"):
        jP, jq, jA, _, _, je = jadmm._ruiz_equilibrate(*(jnp.asarray(a) for a in (P, q, A)), 10)
        jl = je * jnp.clip(jnp.asarray(lo), -1e30, 1e30)
        ju = je * jnp.clip(jnp.asarray(hi), -1e30, 1e30)
        jrho = jadmm._rho_vector(jnp.float32(0.1), jl, ju)
        K_inv = jadmm._factor(jP, jA, jrho, SIGMA)
        jW = np.asarray(jnp.concatenate([SIGMA * K_inv, K_inv @ jA.T], axis=-1))
    # the port's box block from the same QP
    Ps, qs, As, _, _, e = tadmm._ruiz_equilibrate(*(torch.as_tensor(a) for a in (P, q, A)), 10)
    ls, us = e * torch.as_tensor(lo).clamp(-1e30, 1e30), e * torch.as_tensor(hi).clamp(-1e30, 1e30)
    rho = tadmm._rho_vector(torch.tensor(0.1), ls, us)
    A_d, g = tadmm._box_block(As, True)
    assert torch.equal(torch.diag_embed(g), As[m_d:])  # the block stays diagonal
    W_s, _ = tadmm._build_operator(tadmm._factor(Ps, As, rho, SIGMA), As, qs, SIGMA, A_d)
    assert tuple(W_s.shape) == (n, n + m_d)
    W_s = W_s.numpy().astype(np.float64)
    g = g.numpy().astype(np.float64)
    # both fp32 KKT inverses, by other library routines and each refined by
    # two Newton steps: 1e-4 of the operator's largest entry
    atol = 1e-4 * np.abs(jW).max()
    np.testing.assert_allclose(SIGMA * W_s[:, :n], jW[:, :n], rtol=0, atol=SIGMA * 1e-4 * np.abs(W_s).max())
    np.testing.assert_allclose(W_s[:, n:], jW[:, n : n + m_d], rtol=0, atol=atol)
    np.testing.assert_allclose(W_s[:, :n] * g, jW[:, n + m_d :], rtol=0, atol=atol)


# -- plans --------------------------------------------------------------------------


def _control_shape(horizon):
    return 5 * horizon - 2, 8 * horizon - 2


@pytest.mark.parametrize("batch", [1, 7, 16, 256])
def test_plan_box_horizon50_takes_a_cluster_of_three(batch):
    n, m = _control_shape(50)
    plan = plan_chunk(n, m, batch, n)
    assert plan.variant == "cluster" and plan.box
    # 83 W rows of 398 floats and 50 A_d rows of 248: 188,912 bytes at
    # C = 3, where C = 2 would need 272 KB
    assert cluster_smem_bytes(n, m, 3, n) == 188_912
    assert cluster_smem_bytes(n, m, 2, n) > SMEM_PER_BLOCK
    assert plan.cluster == (8 if batch <= ops.CLUSTERS_OF_8 else 3)
    assert plan.smem_bytes == cluster_smem_bytes(n, m, plan.cluster, n) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_plan_box_horizon100_takes_a_cluster(batch):
    # the mapping control: 2.19 MB of operator, 10 CTAs of 227,328 bytes
    n, m = _control_shape(100)
    plan = plan_chunk(n, m, batch, n)
    assert plan == cluster_plan(n, m, 10, n)
    assert plan.smem_bytes == 227_328 <= SMEM_PER_BLOCK
    assert cluster_smem_bytes(n, m, 9, n) > SMEM_PER_BLOCK


@pytest.mark.parametrize("n_points, fewest, C", [(586, 7, 8), (942, 16, 16)])
def test_plan_box_raceline_takes_a_cluster(n_points, fewest, C):
    # A = I alone: W_s = K^-1; 942 points is the largest a cluster holds
    plan = plan_chunk(n_points, n_points, 1, n_points)
    assert (plan.variant, plan.cluster, plan.box) == ("cluster", C, True)
    fits = [c for c in range(1, MAX_CLUSTER + 1) if cluster_smem_bytes(n_points, n_points, c, n_points) <= SMEM_PER_BLOCK]
    assert fits[0] == fewest
    assert plan_chunk(943, 943, 1, 943).variant == "split"


def test_plan_box_raceline_1953_streams_a_third():
    n = 1953
    plan = plan_chunk(n, n, 1, n)
    assert plan == split_plan(n, n, MAX_CLUSTER, n_b=n)
    lay = split_layout(n, n, MAX_CLUSTER, n_b=n)
    # 123 rows of 1,953 floats a CTA, 22 resident; no A rows
    assert (lay.rows_w, lay.rows_a, lay.res_w, lay.res_a) == (123, 0, 22, 0)
    assert plan.smem_bytes == lay.bytes <= SMEM_PER_BLOCK
    # W_s's rows are n floats where W's were 2n and A's n more: a stage
    # of 2,048 floats holds one, and each CTA streams 101 rows of 7,812
    # bytes an iteration (phase 3 of chip_smoke.py prints the same)
    assert n + 3 <= lay.stage_floats < 2 * n + 3
    assert 4 * n * (lay.rows_w - lay.res_w) == 789_012
    dense = split_layout(n, n, MAX_CLUSTER)
    assert (dense.rows_w, dense.rows_a) == (123, 123)


def test_plan_box_largest_control_horizon():
    # the box block's cluster holds control QPs to horizon 127 (dense: 92)
    horizons = [h for h in range(2, 200) if plan_chunk(*_control_shape(h), 1, _control_shape(h)[0]).variant == "cluster"]
    assert horizons == list(range(2, 128))


def test_box_block_spans_all_variables_or_none():
    with pytest.raises(ValueError):
        cluster_smem_bytes(20, 30, 4, n_b=10)
    with pytest.raises(ValueError):
        plan_chunk(20, 10, 1, n_b=20)  # fewer rows than the block


def test_kernel_names():
    assert kernel_name(cluster_plan(248, 398, 3, 248), False) == CLUSTER_BOX
    assert kernel_name(cluster_plan(248, 398, 3, 248), True) == CLUSTER_BOX_ACTIVE
    assert kernel_name(split_plan(1953, 1953, 16, n_b=1953), False) == ops.SPLIT_BOX
    assert kernel_name(split_plan(1953, 1953, 16, n_b=1953), True) == ops.SPLIT_BOX_ACTIVE
    assert kernel_name(cluster_plan(248, 398, 5), False) == ops.CLUSTER
    assert kernel_name(split_plan(498, 798, 16), True) == ops.SPLIT_ACTIVE
    assert len(set(KERNEL_NAMES)) == 8


# -- the wrapper's refusals ---------------------------------------------------------


def _box_args(inp):
    return [*_t(inp, "Ws", "Ad", *VECS)], torch.as_tensor(inp["g"])


def test_wrapper_refuses_bad_box_inputs():
    inp = _qps(2, *LAYOUTS["control"], seed=6)
    args, g = _box_args(inp)
    with pytest.raises(ValueError):  # g without sigma
        admm_chunk(*args, n_iters=1, alpha=ALPHA, g=g)
    with pytest.raises(ValueError):
        admm_chunk(*args, n_iters=1, alpha=ALPHA, g=g, sigma=0.0)
    with pytest.raises(ValueError):  # g of the wrong length
        admm_chunk(*args, n_iters=1, alpha=ALPHA, g=g[:, :-1].contiguous(), sigma=SIGMA)
    with pytest.raises(TypeError):
        admm_chunk(*args, n_iters=1, alpha=ALPHA, g=g.double(), sigma=SIGMA)
    with pytest.raises(ValueError):  # g not contiguous
        admm_chunk(*args, n_iters=1, alpha=ALPHA, g=g.t().contiguous().t(), sigma=SIGMA)
    dense_a = list(args)
    dense_a[1] = torch.as_tensor(inp["A"])  # the dense A with a box block's W
    with pytest.raises(ValueError):
        admm_chunk(*dense_a, n_iters=1, alpha=ALPHA, g=g, sigma=SIGMA)
    # the dense W with g: its columns do not match the box block's vectors
    with pytest.raises(ValueError):
        admm_chunk(*_t(inp, "W", "A", *VECS), n_iters=1, alpha=ALPHA, g=g, sigma=SIGMA)


def test_plans_refuse_the_other_form():
    # a box plan never runs a dense operator, nor a dense plan a box
    # block. Checked before any library is touched.
    inp = _qps(1, *LAYOUTS["control"], seed=7)
    args, g = _box_args(inp)
    n, m = inp["x"].shape[1], inp["z"].shape[1]
    for plan in (cluster_plan(n, m, 4), split_plan(n, m, 4)):
        with pytest.raises(ValueError):
            ops._launch(plan, *args, n_iters=1, alpha=ALPHA, g=g, sigma=SIGMA)
    with pytest.raises(ValueError):
        ops._launch(cluster_plan(n, m, 4, n), *_t(inp, "W", "A", *VECS), n_iters=1, alpha=ALPHA)


def test_no_silent_fallback_off_cpu_with_the_box_block():
    inp = _qps(1, *LAYOUTS["raceline"], seed=8)
    args, g = _box_args(inp)
    with pytest.raises(ValueError):
        admm_chunk(*(a.to("meta") for a in args), n_iters=1, alpha=ALPHA, g=g.to("meta"), sigma=SIGMA)


# -- the solver on the box block ----------------------------------------------------


def _spy(monkeypatch):
    """Records, per chunk the QP engines run (every engine's chunk is
    ``qp/admm.py``'s call), whether it took the box block."""
    calls = []

    def spy(*args, g=None, sigma=None, **kw):
        calls.append(g is not None)
        return admm_chunk(*args, g=g, sigma=sigma, **kw)

    monkeypatch.setattr(tadmm, "admm_chunk", spy)
    return calls


def test_get_control_on_the_box_block_matches_jax(monkeypatch):
    import acmpc_tpu.mpc.spatial_mpc as jmpc
    from acmpc_tpu.config import load_config as jax_load_config
    from acmpc_tpu.dynamics import SpatialBicycleModel as JModel

    mpc, window, _ = _monza_qp()
    cfg = jax_load_config(ROOT / "configs" / "monza.yaml")
    control = dataclasses.replace(cfg.racing_control, horizon=50)
    ref = jmpc.SpatialMPC(control, JModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max))
    calls = _spy(monkeypatch)
    state, _ = mpc.get_control(mpc.initial_state(), window, 28.0)
    jstate, _ = ref.jitted_get_control(ref.initial_state(), jnp.asarray(window), jnp.float32(28.0))
    assert calls and all(calls)
    assert bool(state.solved) and bool(jstate.solved)
    # tests/test_torch_admm.py's X_TOL: both solves stop at the 1e-3
    # residual tolerance on fp32 factorisations that differ in rounding
    for field in ("projected_control", "cum_time", "prediction"):
        np.testing.assert_allclose(
            getattr(state, field).numpy(), np.asarray(getattr(jstate, field)),
            rtol=2e-2, atol=2e-2, err_msg=field,
        )


def test_box_and_dense_solves_agree_and_lanes_stay_single(monkeypatch):
    # the same control QP through the box block and through the dense
    # operator: the same status and solutions within the solver's
    # tolerance; lanes of the box path equal single box solves bit for bit
    P, q, A, lo, hi = (torch.as_tensor(a) for a in _monza_qp(horizon=20)[2])
    calls = _spy(monkeypatch)
    box = tadmm._solve_box_qp(P, q, A, lo, hi, box=True)
    assert calls and all(calls)
    calls.clear()
    dense = tadmm.solve_box_qp(P, q, A, lo, hi)
    assert calls and not any(calls)
    assert int(box.status) == int(dense.status) == tadmm.STATUS_SOLVED
    np.testing.assert_allclose(box.x.numpy(), dense.x.numpy(), rtol=2e-2, atol=2e-2)
    stack = [torch.stack([t, t]) for t in (P, q, A, lo, hi)]
    lanes = tadmm._solve_box_qp(*stack, box=True)
    for f in ("x", "y", "z", "iterations", "status"):
        assert torch.equal(getattr(lanes, f)[1], getattr(box, f)), f
