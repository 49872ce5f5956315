"""The port's agent against the JAX package's (CPU), teacher-forced and
single-threaded: both agents see the same sim observations on the same
fake clock with oracle perception, their control threads are stopped
after construction, and each frame runs perception, the control
thread's solve, the frame step and the actuation in this thread. The
sim is driven by the JAX agent's action.

Per frame: the action within 5e-3 (the golden fixture's tolerance), the
same count of published command sets, the reference speed and the
bootstrap's map speeds within the speed-profile tolerance of
tests/test_torch_mpc.py, and the same termination and mode. With
localisation on (64 particles), the port's filter takes the JAX state
and JAX's draws before each call, and ``is_localised`` and
``estimated_map_index`` agree frame by frame.

Last, the localiser lock: predicts and updates from two threads are
each applied once, in call order.
"""

import threading
import time

import numpy as np
import pytest
import torch

from acmpc_tpu.perception.observations import ObservationDict as JObservationDict
from acmpc_tpu.runtime import Agent as JAgent
from acmpc_tpu_torch.convert import pf_state_to_numpy
from acmpc_tpu_torch.localise.particle_filter import ScriptedDraws, TorchDraws
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.observations import ObservationDict
from acmpc_tpu_torch.runtime import Agent
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from test_torch_localise import _update_draws, to_port
from test_torch_localiser import _predict_draws_n
from torch_agent_cases import (
    COMMAND_TOL,
    SPEED_TOL,
    ClockOnlySim,
    FakeClock,
    configs,
    on_fake_clock,
    save_asymmetric_map,
    stopped_control_thread,
    teacher_forced_frame,
)

FRAMES = 30
N_PARTICLES = 64
UPDATE_S = 0.02  # the stretched update of the lock test
SPEED = dict(rel=1e-4, abs=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def map_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("agent") / "track.npz"
    save_asymmetric_map(path)
    return str(path)


@pytest.fixture
def pair(map_path, request):
    """(port agent, JAX agent, their stopped control threads, a sim, the
    fake clock), reduced alike; ``request.param`` holds localisation
    overrides."""
    cfg, jcfg = configs(map_path, **getattr(request, "param", {}))
    clock = FakeClock()
    with on_fake_clock(clock):
        ours = Agent(cfg, ClockOnlySim(clock), use_oracle_perception=True, device="cpu")
        ref = JAgent(jcfg, ClockOnlySim(clock), use_oracle_perception=True)
        threads = stopped_control_thread(ours), stopped_control_thread(ref)
        sim = SyntheticSimulator(
            load_track_map(map_path, device="cpu"), CameraInfo.from_config(cfg.perception),
            dt=0.05, start_index=50, half_width=5.0,
        )
        try:
            yield ours, ref, threads, sim, clock
        finally:
            ours.teardown()
            ref.teardown()


def test_teacher_forced_actions_equal_jax(pair):
    ours, ref, (thread, jthread), sim, clock = pair
    raw = sim.reset()
    for k in range(FRAMES):
        clock.t = sim.t
        want = np.asarray(teacher_forced_frame(ref, jthread, raw, jax_side=True))
        got = teacher_forced_frame(ours, thread, raw, jax_side=False)
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, err_msg=f"frame {k}", **COMMAND_TOL)
        assert ours.controller.command_version == ref.controller.command_version == k + 1
        assert ours.reference_speed == pytest.approx(ref.reference_speed, **SPEED)
        assert ours._is_mapping is ref._is_mapping is False
        raw = sim.step(want)
        assert ours.termination_condition(raw) == ref.termination_condition(raw)
    assert ours.reference_speeds.shape == ref.reference_speeds.shape
    np.testing.assert_allclose(ours.reference_speeds, ref.reference_speeds, **SPEED_TOL)
    assert not ours.controller.is_mapping and ours.racing_setup_ms > 0
    assert sim.distance > 20.0 and sim.v > 5.0, "the JAX agent's actions drove the car"


@pytest.mark.parametrize(
    "pair",
    [dict(use_localisation=True, n_particles=N_PARTICLES, n_converged_particles=N_PARTICLES)],
    indirect=True,
    ids=["localisation"],
)
def test_teacher_forced_localisation_equals_jax(pair):
    ours, ref, (thread, jthread), sim, clock = pair
    raw = sim.reset()
    ref._maybe_setup_racing()
    ours._maybe_setup_racing()
    jloc, loc = ref.localiser, ours.localiser
    loc._draws = ScriptedDraws([], "cpu")
    n = loc._pf_config.n_particles
    assert n == N_PARTICLES
    for k in range(FRAMES):
        clock.t = sim.t
        jobs, obs = JObservationDict(raw), ObservationDict(raw)
        # this frame's update, from the JAX state with JAX's draws
        loc._state = to_port(jloc._state)
        loc._draws.extend(_update_draws(jloc._state.key, n, False, False))
        ref._update_perception(jobs, raw)
        ours._update_perception(obs, raw)
        assert len(loc._draws) == 0
        assert ours.is_localised == ref.is_localised, f"frame {k} update"
        assert ours.localiser.estimated_map_index == ref.localiser.estimated_map_index, f"frame {k}"
        for agent, control in ((ref, jthread), (ours, thread)):
            control._solve(*agent.controller._centreline_box.read()[0])
        # this frame's predict, likewise
        loc._state = to_port(jloc._state)
        loc._draws.extend([("normal", d) for d in _predict_draws_n(jloc._state.key, n)])
        ref._step(jobs)
        ours._step(obs)
        assert len(loc._draws) == 0
        assert ours.is_localised == ref.is_localised, f"frame {k} step"
        want = np.asarray(ref.control_input)
        np.testing.assert_allclose(ours.control_input, want, err_msg=f"frame {k}", **COMMAND_TOL)
        assert ours.reference_speed == pytest.approx(ref.reference_speed, **SPEED)
        raw = sim.step(want)
    assert ours.controller.command_version == ref.controller.command_version == FRAMES


@pytest.mark.parametrize(
    "pair",
    [dict(use_localisation=True, n_particles=N_PARTICLES, n_converged_particles=N_PARTICLES)],
    indirect=True,
    ids=["localisation"],
)
def test_localiser_lock_applies_every_call_in_order(pair):
    """N frame steps and N perception updates from two threads, with
    counting wrappers around the filter's predict and update (the update
    stretched by a sleep, so that predicts are due while it runs): both
    counts are N, each call starts from the state the previous one left,
    and the final state equals a serial replay of the recorded call order
    from the same start with a fresh draw source of the same seed."""
    ours, _, _, sim, clock = pair
    n_calls = 12
    ours._setup_racing()
    raws = [sim.reset()] + [sim.step(np.array([0.0, 0.0, 0.3])) for _ in range(n_calls - 1)]
    loc, pf = ours.localiser, ours.localiser._pf
    start, draws = loc._state, loc._draws
    real = {"predict": pf.predict, "update": pf.update}
    calls = []

    def counted(kind):
        def call(state, *args, **kw):
            if kind == "update":
                # an update takes 6-10 ms of dispatch on the card: give
                # the frame thread's predicts a window to land in
                time.sleep(UPDATE_S)
            out = real[kind](state, *args, **kw)
            calls.append((kind, state, args, kw, out))
            return out

        return call

    pf.predict, pf.update = counted("predict"), counted("update")
    barrier = threading.Barrier(2)
    errors = []

    def frames():
        barrier.wait()
        for k, raw in enumerate(raws):
            clock.t = 0.05 * (k + 1)
            ours._step(ObservationDict(raw))
            time.sleep(UPDATE_S / 4)

    def perception():
        barrier.wait()
        for raw in raws:
            ours._update_perception(ObservationDict(raw), raw)

    def guarded(fn):
        def run():
            try:
                fn()
            except Exception as e:  # surfaced below
                errors.append(e)

        return run

    workers = [threading.Thread(target=guarded(f)) for f in (frames, perception)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    del pf.predict, pf.update
    assert not errors, errors
    kinds = [c[0] for c in calls]
    assert kinds.count("predict") == n_calls and kinds.count("update") == n_calls
    state = start
    for i, (kind, given, *_rest, out) in enumerate(calls):
        assert given is state, f"call {i} ({kind}) started from a stale state"
        state = out
    assert loc._state is state
    replay_draws = TorchDraws(ours.cfg.seed, "cpu")
    state = start
    for kind, _, args, kw, _ in calls:
        args = tuple(replay_draws if a is draws else a for a in args)
        state = real[kind](state, *args, **kw)
    got, want = pf_state_to_numpy(loc._state), pf_state_to_numpy(state)
    for field in want:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)


def test_default_device_is_the_card(map_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg, _ = configs(map_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(cfg)


def _free_running(cfg, map_path, start_index, frames, oracle):
    """tests/test_agent_e2e.py's free-running drive on the port: the
    agent's own threads, paced on solve freshness every 4th frame.
    Returns (distance gained, maximum off-track, final speed, agent)."""
    sim = SyntheticSimulator(
        load_track_map(map_path, device="cpu"), CameraInfo.from_config(cfg.perception),
        dt=0.05, start_index=start_index, half_width=5.0,
    )
    centre = sim.map.centre.numpy()
    agent = Agent(cfg, sim, use_oracle_perception=oracle, device="cpu")
    try:
        obs = sim.reset()
        agent.behaviour(obs)
        assert agent.controller.wait_for_first_command(timeout=240), "control thread never published"
        d0, offtrack = sim.distance, 0.0
        cmd_v = agent.controller.command_version
        for step in range(frames):
            action = agent.behaviour(obs)
            assert action.shape == (3,)
            obs = sim.step(action)
            if step % 4 == 3:
                cmd_v = agent.controller.wait_for_command_newer_than(cmd_v)
            offtrack = max(offtrack, float(np.linalg.norm(centre - sim.pose[:2], axis=1).min()))
        return sim.distance - d0, offtrack, sim.v, agent
    finally:
        agent.teardown()


@pytest.mark.slow
def test_agent_drives_the_synthetic_track(map_path):
    cfg, _ = configs(map_path)
    distance, offtrack, speed, _ = _free_running(cfg, map_path, 50, 150, oracle=True)
    assert distance > 50.0, f"car barely moved: {distance:.1f} m"
    assert offtrack < 5.0, f"car left the track: {offtrack:.2f} m"
    assert speed > 10.0, f"never accelerated: v={speed:.1f}"


@pytest.mark.slow
def test_agent_drives_with_real_perception(map_path):
    """The shipped segmentation model in the loop at its training camera,
    as tests/test_agent_e2e.py's real-perception case."""
    import dataclasses

    cfg, _ = configs(map_path)
    cfg = dataclasses.replace(
        cfg, perception=dataclasses.replace(cfg.perception, camera_position=(0.0, 0.0, 1.2), camera_pitch_deg=9.0)
    )
    distance, offtrack, _, agent = _free_running(cfg, map_path, 200, 120, oracle=False)
    assert distance > 20.0, "car made no progress"
    assert offtrack < 5.0, f"car left the track: {offtrack:.2f} m"
    assert agent._latest_frames.get("semantics") is not None
