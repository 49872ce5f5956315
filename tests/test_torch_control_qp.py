"""Control-QP assembly at horizon 50: the port against the JAX package,
element by element, on identical path fields (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.dynamics import SpatialBicycleModel as JModel
from acmpc_tpu.dynamics import VehicleParams as JVehicle
from acmpc_tpu.geometry.path import ReferencePath as JPath
from acmpc_tpu.mpc.control_qp import assemble_control_qp as jax_assemble
from acmpc_tpu.mpc.control_qp import control_qp_sizes as jax_sizes
from acmpc_tpu_torch.dynamics import SpatialBicycleModel, VehicleParams
from acmpc_tpu_torch.geometry.path import ReferencePath
from acmpc_tpu_torch.mpc.control_qp import assemble_control_qp, control_qp_sizes

FIELDS = ("xs", "ys", "psis", "kappas", "distances", "widths", "velocities")
COSTS = ((4e-3, 5e-2, 0.0), (1e-2, 10.0), (1.0, 0.0, 0.1))
# same fp32 arithmetic on the same inputs; the time-row coefficients
# 1/(v ds) may differ in the last ulp
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: one intra-op thread per test worker
    # avoids oversubscribing the cores the parallel test run shares
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _path_fields(batch, n=49, seed=0):
    rng = np.random.default_rng(seed)
    f = {
        "xs": rng.normal(size=(batch, n)),
        "ys": rng.normal(size=(batch, n)),
        "psis": rng.uniform(-3, 3, size=(batch, n)),
        "kappas": rng.normal(scale=0.03, size=(batch, n)),
        "distances": rng.uniform(1.5, 2.5, size=(batch, n)),
        "widths": rng.uniform(6, 10, size=(batch, n)),
        "velocities": rng.uniform(8, 30, size=(batch, n)),
    }
    state = rng.normal(scale=[0.5, 0.1, 0.0], size=(batch, 3))
    return {k: v.astype(np.float32) for k, v in f.items()}, state.astype(np.float32)


def _models():
    return (
        SpatialBicycleModel(VehicleParams(), 8.0, 84.0),
        JModel(JVehicle(), 8.0, 84.0),
    )


def test_sizes():
    assert control_qp_sizes(50) == jax_sizes(50) == (248, 398)


@pytest.mark.parametrize("time_mode", ["tuned", "reference", "exact"])
def test_assembly_matches_jax(time_mode):
    fields, state = _path_fields(1)
    model, jmodel = _models()
    path = ReferencePath(**{k: torch.as_tensor(v[0]) for k, v in fields.items()})
    jp = JPath(**{k: jnp.asarray(v[0]) for k, v in fields.items()})
    got = assemble_control_qp(
        path, torch.as_tensor(state[0]), model, *COSTS, time_mode=time_mode
    )
    want = jax_assemble(
        jp, jnp.asarray(state[0]), jmodel, *(jnp.asarray(c) for c in COSTS),
        time_mode=time_mode,
    )
    for name, g, w in zip("PqAlu", got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_batched_assembly_and_input_box_override():
    fields, state = _path_fields(3, seed=1)
    model, jmodel = _models()
    path = ReferencePath(**{k: torch.as_tensor(v) for k, v in fields.items()})
    jp = JPath(**{k: jnp.asarray(v) for k, v in fields.items()})
    u_min, u_max = np.array([5.0, -0.2]), np.array([30.0, 0.2])
    got = assemble_control_qp(
        path, torch.as_tensor(state), model, *COSTS, u_min=u_min, u_max=u_max
    )
    want = jax.vmap(
        lambda p, s: jax_assemble(
            p, s, jmodel, *(jnp.asarray(c) for c in COSTS), u_min=u_min, u_max=u_max
        )
    )(jp, jnp.asarray(state))
    for name, g, w in zip("PqAlu", got, want):
        assert g.shape == w.shape == (3,) + tuple(w.shape[1:]), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # batch member equals the unbatched assembly
    single = assemble_control_qp(
        dataclasses.replace(path, **{k: getattr(path, k)[1] for k in FIELDS}),
        torch.as_tensor(state[1]), model, *COSTS, u_min=u_min, u_max=u_max,
    )
    for g, s in zip(got, single):
        torch.testing.assert_close(g[1], s, rtol=0, atol=0)
