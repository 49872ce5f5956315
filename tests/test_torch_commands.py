"""Temporal command selection: the port's host-side selectors against the
JAX package's on the same random command trajectories, including elapsed
times before the first command and after the last."""

import numpy as np
import pytest

from acmpc_tpu.runtime.commands import (
    TemporalCommandInterpolator as JInterpolator,
    TemporalCommandSelector as JSelector,
)
from acmpc_tpu_torch.runtime.commands import (
    TemporalCommandInterpolator,
    TemporalCommandSelector,
)


def _trajectory(seed, n=49):
    rng = np.random.default_rng(seed)
    cum_time = np.concatenate([[0.0], np.cumsum(rng.uniform(0.02, 0.2, n - 1))])
    commands = rng.normal(size=(n, 2)).astype(np.float32)
    # before the first command, on commands, between them, after the last
    elapsed = np.concatenate([
        [-0.5, -1e-3, 0.0],
        cum_time[[1, n // 2, n - 1]],
        rng.uniform(0.0, cum_time[-1], 20),
        [cum_time[-1] + 1e-3, cum_time[-1] + 2.0],
    ])
    return cum_time.astype(np.float32), commands, elapsed


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize(
    "ours, ref", [(TemporalCommandSelector, JSelector), (TemporalCommandInterpolator, JInterpolator)]
)
def test_selectors_match_jax(seed, ours, ref):
    cum_time, commands, elapsed = _trajectory(seed)
    for t in elapsed:
        # the same numpy arithmetic on both sides: equal
        np.testing.assert_array_equal(
            ours()(cum_time, commands, t), ref()(cum_time, commands, t), err_msg=str(t)
        )


def test_selector_steps_back_and_wraps():
    cum_time = np.array([0.0, 0.1, 0.2], np.float32)
    commands = np.array([[1.0], [2.0], [3.0]], np.float32)
    select = TemporalCommandSelector()
    # the nearest command is still ahead: step back one
    assert select(cum_time, commands, 0.09)[0] == 1.0
    assert select(cum_time, commands, 0.11)[0] == 2.0
    # ahead of the first command, index 0 steps back to the last
    assert select(cum_time, commands, -0.01)[0] == 3.0
    assert select(cum_time, commands, 5.0)[0] == 3.0
