"""Shared set-up of the port's agent tests (not a test module): the JAX
e2e tests' small configurations for both packages, their maps, a fake
clock, and one teacher-forced agent frame.

Sizes are those of tests/test_agent_e2e.py and tests/test_mapping_e2e.py:
a 320x192 camera (bonnet 160, 200 polyfit points), both MPCs at horizon
20, localisation off unless asked for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import types

import numpy as np
import pytest

import acmpc_tpu.runtime.pid as j_pid_module
import acmpc_tpu.utils.compile_cache as j_compile_cache
import acmpc_tpu_torch.runtime.pid as pid_module
from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.perception.observations import ObservationDict as JObservationDict
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.localise.track_map import save_track_map
from acmpc_tpu_torch.perception.observations import ObservationDict
from test_localise import make_asymmetric_map

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "monza.yaml"
# commands and actions: the golden fixture's tolerance (both engines stop
# on fp32 factorisations that differ in rounding)
COMMAND_TOL = dict(rtol=5e-3, atol=5e-3)
# a speed profile over a map: up to thousands of slacks summed in other
# orders (tests/test_torch_mpc.py)
SPEED_TOL = dict(rtol=1e-4, atol=1e-3)


class FakeClock:
    """A settable clock: the sim time both agents run on."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class ClockOnlySim:
    """The agent's view of a simulator in a teacher-forced run: a clock
    and ``close``; the observations come from elsewhere."""

    def __init__(self, clock: FakeClock):
        self.clock = clock

    def close(self):
        pass


def save_asymmetric_map(path: pathlib.Path) -> np.ndarray:
    """tests/test_localise.py's asymmetric 1500-point loop saved as .npz
    (read the same by both packages); returns its centre."""
    tm = make_asymmetric_map()
    save_track_map(path, np.asarray(tm.centre), np.asarray(tm.left), np.asarray(tm.right))
    return np.asarray(tm.centre)


def shrink(cfg, map_path: str, mapping: bool = False, **localisation):
    """The e2e tests' reduction of monza's config, for either package's
    dataclasses: with ``mapping`` the mapping session of
    tests/test_mapping_e2e.py (one lap, mapping horizon 20 at 14 m/s,
    racing at 25 m/s), else tests/test_agent_e2e.py's (racing at 30 m/s)."""
    r = dataclasses.replace
    cfg = r(
        cfg,
        perception=r(
            cfg.perception, image_width=320, image_height=192,
            n_rows_to_remove_bonnet=160, n_polyfit_points=200,
        ),
        racing_control=r(
            cfg.racing_control, horizon=20,
            constraints=r(cfg.racing_control.constraints, v_max=25.0 if mapping else 30.0),
        ),
        localisation=r(cfg.localisation, **{"use_localisation": False, **localisation}),
        map_path=map_path,
    )
    if mapping:
        cfg = r(
            cfg,
            mapping_control=r(
                cfg.mapping_control, horizon=20,
                constraints=r(cfg.mapping_control.constraints, v_max=14.0),
            ),
            create_map=True,
            n_mapping_laps=1,
        )
    return cfg


def configs(map_path: str, mapping: bool = False, **localisation):
    """(port config, JAX config), reduced alike."""
    return (
        shrink(load_config(CONFIG), map_path, mapping, **localisation),
        shrink(j_load_config(CONFIG), map_path, mapping, **localisation),
    )


@contextlib.contextmanager
def on_fake_clock(clock: FakeClock):
    """Both packages' PIDs read ``clock`` where they read the wall clock,
    and the JAX agent enables no persistent compile cache (tests use
    none, see tests/conftest.py)."""
    fake_time = types.SimpleNamespace(monotonic=clock)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pid_module, "time", fake_time)
        mp.setattr(j_pid_module, "time", fake_time)
        mp.setattr(j_compile_cache, "enable_compile_cache", lambda: None)
        yield


def stopped_control_thread(agent):
    """Stop the agent's control thread and return it, unstarted work
    aside: its ``_solve`` then runs on the caller's thread."""
    thread = agent.controller._thread
    agent.controller.shutdown()
    return thread


def teacher_forced_frame(agent, thread, raw: dict, jax_side: bool):
    """One frame of ``Agent.behaviour`` with the worker and the control
    thread run synchronously in this thread, in the order perception,
    solve, frame step, actuation. Returns the action."""
    if agent._is_mapping:
        if agent._is_mapping_laps_completed(raw):
            return agent._finalise_mapping(raw)
    else:
        agent._maybe_setup_racing()
    obs = (JObservationDict if jax_side else ObservationDict)(raw)
    agent._update_perception(obs, raw)
    item, _, _ = agent.controller._centreline_box.read()
    thread._solve(*item)
    agent._step(obs)
    return agent.control_input
