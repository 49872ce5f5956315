"""The Pacejka dynamic bicycle model: the port's ``dynamics/pacejka.py``
against the JAX package's on the CPU (fp32 on both sides)."""

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.dynamics import pacejka


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    from acmpc_tpu.dynamics.pacejka import DynamicBicycleModel

    return pacejka.DynamicBicycleModel(device="cpu"), DynamicBicycleModel()


@pytest.mark.parametrize("data", ["ACCELERATION_DATA", "BRAKING_DATA"])
def test_fit_long_force_matches_jax(data):
    from acmpc_tpu.dynamics import pacejka as jp

    np.testing.assert_array_equal(getattr(pacejka, data), getattr(jp, data))
    got = pacejka.fit_long_force(getattr(pacejka, data), device="cpu")
    want = np.asarray(jp.fit_long_force(getattr(jp, data)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    # the fit reproduces the samples it was fitted to
    fitted = pacejka.long_force(getattr(pacejka, data)[:2], got)
    np.testing.assert_allclose(fitted, getattr(pacejka, data)[2], atol=1e-3)


def test_x_dot_matches_jax_on_random_states(models):
    ours, ref = models
    rng = np.random.default_rng(0)
    states = np.concatenate(
        [
            rng.uniform(-50, 50, (256, 2)),
            rng.uniform(-np.pi, np.pi, (256, 1)),
            rng.uniform(0.5, 60, (256, 1)),
            rng.uniform(-2, 2, (256, 1)),
            rng.uniform(-1, 1, (256, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    controls = np.stack(
        [rng.uniform(-0.3, 0.3, 256), rng.uniform(-1, 1, 256)], axis=1
    ).astype(np.float32)
    got = ours.x_dot(torch.tensor(states), torch.tensor(controls)).numpy()
    want = np.asarray(ref.x_dot(states, controls))
    assert got.shape == want.shape == (256, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("steer", [0.0, 0.1])
def test_rollout_matches_jax(models, steer):
    ours, ref = models
    state = np.array([0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    controls = np.tile(np.array([steer, 1.0]), (40, 1))
    got = ours.rollout(state, controls, dt=0.05).numpy()
    want = np.asarray(ref.rollout(state, controls, dt=0.05))
    assert got.shape == want.shape == (40, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    nxt, xd = ours.predict_next_state(state, controls[0])
    jn, jxd = ref.predict_next_state(state, controls[0])
    np.testing.assert_allclose(nxt.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xd.numpy(), np.asarray(jxd), rtol=1e-4, atol=1e-4)


def test_pacejka_straight_line_accelerates(models):
    # tests/test_tools.py::test_pacejka_straight_line_accelerates on the port
    model, _ = models
    state = np.array([0.0, 0.0, 0.0, 10.0, 0.0, 0.0])
    controls = np.tile(np.array([0.0, 1.0]), (40, 1))
    traj = model.rollout(state, controls, dt=0.05).numpy()
    assert traj[-1, 3] > 10.5
    assert abs(traj[-1, 1]) < 1.0
    controls[:, 0] = 0.1
    traj2 = model.rollout(state, controls, dt=0.05).numpy()
    assert abs(traj2[-1, 1]) > 1.0


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pacejka.DynamicBicycleModel()
