"""The compiled entries of the port on the CPU, against their eager forms
and the JAX package's jitted ones.

On the CPU ``ops/graph_loop`` captures nothing: ``device_while`` is the
host loop and a ``GraphCache`` runs its function eagerly, so these tests
hold the arithmetic the card's graphs capture:

* the QP's chunk loop through ``device_while`` (fixed rho) equals the
  host loop that ``_solve_one`` keeps for adaptive rho, with the rho
  band made infinite so that it never adapts, bit for bit, on a QP that
  converges, one that runs to ``max_iter`` and one certified primal
  infeasible; and the same QPs match JAX's ``solve_box_qp`` at
  tests/test_torch_admm.py's tolerances;
* ``SpatialMPC.jitted_get_control`` against JAX's ``jitted_get_control``
  over three carried steps at tests/test_torch_mpc.py's tolerances, on
  monza's horizon-50 racing windows and a horizon-100 mapping window, and
  bit-equal to the port's ``get_control``;
* ``TrackLimitExtractor.jitted()``, ``Perceiver._pipeline`` and
  ``TrackSegmenterAOT`` equal to their eager forms, and to JAX's jitted
  ones at tests/test_torch_perception.py's tolerances;
* the control thread's solve goes through ``jitted_get_control``.

The on-card cases (replays bit-equal to eager, a capture that reads the
card raising, a replay with no synchronisation) are in
tests/test_torch_cuda.py.
"""

import collections
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acmpc_tpu.mpc.spatial_mpc as jmpc
from acmpc_tpu.config import load_config as jax_load_config
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel
from acmpc_tpu.qp.admm import ADMMConfig as JConfig
from acmpc_tpu.qp.admm import solve_box_qp as jax_solve
from acmpc_tpu_torch.bench.graph_entries import make_mpc
from acmpc_tpu_torch.convert import mpc_state_to_numpy, qp_from_numpy
from acmpc_tpu_torch.geometry.tracks import battery
from acmpc_tpu_torch.ops import graph_loop
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter, TrackSegmenterAOT
from acmpc_tpu_torch.qp.admm import ADMMConfig, _solve_one
from acmpc_tpu_torch.runtime.controller import Controller, _ControlThread
from test_admm import _random_qp
from test_torch_admm import BATCH_KW, X_TOL
from test_torch_mpc import ROOT, _assert_states_close, _monza
from test_torch_perception import (
    MASK_AGREE,
    SMALL,
    _assert_tracks_match,
    _cfgs,
    _extractors,
    shipped_pair,  # noqa: F401  (a fixture)
    sim_masks,  # noqa: F401  (a fixture)
)

QP_FIELDS = ("x", "y", "z", "status", "iterations", "r_prim", "r_dual")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- device_while ------------------------------------------------------------


def test_device_while_on_the_cpu_is_the_host_loop():
    def cond(carry):
        return carry[0] < 7

    def body(carry):
        i, acc = carry
        return i + 1, acc * 2 + i

    i, acc = graph_loop.device_while(cond, body, (torch.tensor(0), torch.tensor(1.0)))
    want_acc = 1.0
    for k in range(7):
        want_acc = want_acc * 2 + k
    assert int(i) == 7 and float(acc) == want_acc
    # the condition is tested before the first trip, as lax.while_loop does
    i, acc = graph_loop.device_while(cond, body, (torch.tensor(9), torch.tensor(1.0)))
    assert int(i) == 9 and float(acc) == 1.0


def test_counts_and_graph_caches_run_eagerly_on_the_cpu():
    counter = collections.Counter()
    graph_loop.count_launch(counter, "k")
    graph_loop.count_launch(counter, "k")
    assert counter == {"k": 2}
    calls = []
    cache = graph_loop.GraphCache(lambda x: (calls.append(1), [x + 1, x * 2])[1], "f")
    a, b = cache(torch.arange(3.0))
    assert torch.equal(a, torch.tensor([1.0, 2.0, 3.0])) and torch.equal(b, torch.tensor([0.0, 2.0, 4.0]))
    assert len(calls) == 1 and cache.graphs == {}
    graph_loop.settle_launches()  # no graph: nothing to read


def _infeasible_qp():
    """tests/test_torch_admm.py's contradictory rows: x0 == 0 and x0 == 5."""
    rng = np.random.default_rng(3)
    n = 12
    Mx = rng.normal(size=(n, n))
    P = (Mx @ Mx.T + np.eye(n)).astype(np.float32)
    q = rng.normal(size=n).astype(np.float32)
    A = np.vstack([np.eye(n)[:1], np.eye(n)[:1], np.eye(n)]).astype(np.float32)
    l = np.full(n + 2, -10.0, np.float32)
    u = np.full(n + 2, 10.0, np.float32)
    l[0] = u[0] = 0.0
    l[1] = u[1] = 5.0
    return tuple(jnp.asarray(v) for v in (P, q, A, l, u))


# (QP, engine settings, expected status)
QPS = {
    "converged": (
        lambda: _random_qp(np.random.default_rng(1), 30, 45, eq_rows=5, loose_rows=5),
        dict(BATCH_KW),
        1,
    ),
    "max_iter": (
        lambda: _random_qp(np.random.default_rng(5), 30, 40),
        dict(adaptive_rho=False, max_iter=75, check_every=25, eps_abs=1e-9, eps_rel=1e-9),
        0,
    ),
    "primal_infeasible": (_infeasible_qp, dict(adaptive_rho=False), 2),
}


@pytest.mark.parametrize("case", sorted(QPS))
def test_device_loop_equals_the_host_loop(case):
    make, kw, status = QPS[case]
    qp = qp_from_numpy(*(np.asarray(a) for a in make()), device="cpu")
    loop, _ = _solve_one(*qp, ADMMConfig(**kw), None, None)
    # the host loop of adaptive rho, with a band it never leaves
    host_kw = dict(kw, adaptive_rho=True, adaptive_rho_tol=math.inf)
    host, rho = _solve_one(*qp, ADMMConfig(**host_kw), None, None)
    assert float(rho) == np.float32(ADMMConfig(**kw).rho)  # never adapted
    assert int(loop.status) == status
    for field in QP_FIELDS:
        a, b = getattr(loop, field), getattr(host, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert loop.iterations.dtype == torch.int32 and loop.iterations.dim() == 0


@pytest.mark.parametrize("case", sorted(QPS))
def test_device_loop_matches_jax(case):
    make, kw, status = QPS[case]
    qp = make()
    ref = jax.jit(lambda *a: jax_solve(*a, JConfig(**kw)))(*qp)
    ours, _ = _solve_one(*qp_from_numpy(*(np.asarray(a) for a in qp), device="cpu"), ADMMConfig(**kw), None, None)
    assert int(ours.status) == int(ref.status) == status
    if status == 2:
        # tests/test_torch_admm.py's certificate test: within a chunk
        assert abs(int(ours.iterations) - int(ref.iterations)) <= kw.get("check_every", 25)
    else:
        assert int(ours.iterations) == int(ref.iterations)
        np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), **X_TOL)


# -- jitted_get_control --------------------------------------------------------


def _mapping():
    """(port MPC, JAX MPC) for monza's mapping control (horizon 100)."""
    cfg = jax_load_config(ROOT / "configs" / "monza.yaml")
    control = cfg.mapping_control
    ref = jmpc.SpatialMPC(control, JModel(cfg.vehicle, control.constraints.v_min, control.constraints.v_max))
    return make_mpc("mapping", "cpu"), ref


def _carried_steps(ours, ref, windows, v_max):
    """Each side's own carried state through three windows; the port's
    jitted entry against JAX's and against the port's eager step."""
    state, jstate = ours.initial_state(), ref.initial_state()
    for name, window in windows:
        window = window.astype(np.float32)
        new, diags = ours.jitted_get_control(state, window, v_max)
        eager, eager_diags = ours.get_control(state, window, v_max)
        jnew, jdiags = ref.jitted_get_control(jstate, jnp.asarray(window), jnp.float32(v_max))
        assert bool(new.solved), name
        for a, b in zip(dataclasses.astuple(new) + dataclasses.astuple(diags),
                        dataclasses.astuple(eager) + dataclasses.astuple(eager_diags)):
            assert torch.equal(a, b), name
        _assert_states_close(new, jnew)
        assert int(diags.speed_status) == int(jdiags.speed_status) == 1
        state, jstate = new, jnew
    return state


def test_jitted_get_control_matches_jax_racing():
    ours, ref = _monza()
    windows = battery(50)
    state = _carried_steps(ours, ref, [(n, windows[n]) for n in ("curve", "chicane", "hairpin_r60")], 28.0)
    assert mpc_state_to_numpy(state)["qp_x"].shape == (248,)
    # one graph signature, one cache entry (on the CPU nothing is captured)
    assert ours.jitted_get_control is ours.jitted_get_control


def test_jitted_get_control_matches_jax_mapping():
    ours, ref = _mapping()
    assert ours.horizon == 100
    window = battery(100)["curve"]
    _carried_steps(ours, ref, [("curve", window)] * 3, float(ours.config.constraints.v_max))


# -- perception ----------------------------------------------------------------


def test_jitted_extractor_matches_eager_and_jax(sim_masks):  # noqa: F811
    jext, ext = _extractors(SMALL)
    jitted = ext.jitted()
    assert ext.jitted() is jitted
    for mask in sim_masks[:3]:
        mask_t = torch.from_numpy(mask)
        got, eager = jitted(mask_t), ext.extract(mask_t)
        assert set(got) == set(eager)
        for key in got:
            assert torch.equal(got[key], eager[key]), key
        with jax.default_matmul_precision("highest"):
            want = jext(jnp.asarray(mask))
        _assert_tracks_match(want, got)


def test_pipeline_matches_eager_and_jax(shipped_pair):  # noqa: F811
    jperc, perc, frame, _ = shipped_pair
    image = torch.from_numpy(frame)
    d, s, t = perc._pipeline(image)
    d0, s0, t0 = perc._run_pipeline(image)
    assert torch.equal(d, d0) and torch.equal(s, s0)
    for key in t0:
        assert torch.equal(t[key], t0[key]), key
    with jax.default_matmul_precision("highest"):
        jd, _, jt = jperc._pipeline(jperc.segmenter.variables, jnp.asarray(frame))
    assert (d.numpy() == np.asarray(jd)).mean() >= MASK_AGREE
    if np.array_equal(d.numpy(), np.asarray(jd)):
        _assert_tracks_match(jt, t)
    else:  # a flipped near-tie pixel may move one boundary point
        for key in ("left", "right", "centre"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(jt[key]), rtol=1e-3, atol=0.05)


def test_segmenter_aot_equals_eager(shipped_pair):  # noqa: F811
    _, perc, frame, _ = shipped_pair
    _, t = _cfgs(**SMALL)
    aot = TrackSegmenterAOT(t, device="cpu")
    a, sa = aot.segment_drivable_area(frame)
    b, sb = TrackSegmenter(t, device="cpu").segment_drivable_area(frame)
    assert torch.equal(a, b) and torch.equal(sa, sb)


# -- the control thread --------------------------------------------------------


def test_control_thread_solves_through_jitted_get_control(monkeypatch):
    from torch_agent_cases import configs

    cfg, _ = configs(str(ROOT / "data" / "maps" / "monza.npz"))
    controller = Controller(dataclasses.replace(cfg, create_map=False), device="cpu")
    mpc = controller.mpc
    calls = []
    jitted = mpc.jitted_get_control

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return jitted(*args, **kwargs)

    monkeypatch.setattr(mpc, "jitted_get_control", spy)
    centreline = np.stack([np.zeros(120), np.linspace(0.0, 60.0, 120)], axis=1).astype(np.float32)
    _ControlThread(controller)._solve(centreline, 1.0)
    assert calls == [(mpc.horizon, 3)]
    assert controller.n_solves == 1 and controller.command_version == 1
    assert controller._command_box.read()[0].controls.shape == (mpc.horizon - 1, 2)
