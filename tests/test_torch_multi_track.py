"""All-tracks batched solve: the port's MultiTrackMPC against the golden
fixture (horizon 50), against each track's own port SpatialMPC, against
its own grid form and against the live JAX MultiTrackMPC (horizon 16),
on the CPU."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as jax_load_config
from acmpc_tpu.dynamics import SpatialBicycleModel as JModel
from acmpc_tpu.mpc import multi_track as jmt
from acmpc_tpu.mpc.spatial_mpc import SpatialMPC as JMPC
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.dynamics import SpatialBicycleModel
from acmpc_tpu_torch.geometry.tracks import get_hairpin_track, with_widths
from acmpc_tpu_torch.mpc import multi_track as tmt
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_controls.npz"
TRACKS = [
    "monza", "spa", "silverstone", "nordschleife",
    "vallelunga", "bathurst", "yas_marina",
]
# the golden fixture's tolerance (tests/test_golden.py); also the JAX
# package's own per-track check: both stop at a 1e-3 residual on fp32
# factorisations that differ in rounding
TOL = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(horizon):
    agent = [load_config(ROOT / "configs" / f"{t}.yaml") for t in TRACKS]
    return agent, [dataclasses.replace(c.racing_control, horizon=horizon) for c in agent]


def _port_mt(horizon):
    agent, configs = _configs(horizon)
    model = SpatialBicycleModel(
        agent[0].vehicle, configs[0].constraints.v_min, configs[0].constraints.v_max
    )
    return tmt.MultiTrackMPC(SpatialMPC(configs[0], model, device="cpu"), configs), agent, configs


def _hairpins(horizon, extra=0.0):
    return np.stack(
        [with_widths(get_hairpin_track(40.0 + 5 * i + extra, horizon)) for i in range(len(TRACKS))]
    ).astype(np.float32)


def _caps(configs):
    return np.array([min(30.0, c.unlocalised_max_speed or 30.0) for c in configs], np.float32)


@pytest.fixture(scope="module")
def h16():
    """The port's MultiTrackMPC at horizon 16 and one solve of the 7
    hairpins, beside the JAX package's."""
    mt, agent, configs = _port_mt(16)
    refs, caps = _hairpins(16), _caps(configs)
    out, diags = mt.get_control(mt.initial_states(), refs, v_max_runtime=caps)
    return mt, agent, configs, refs, caps, out, diags


def test_seven_tracks_at_horizon50_match_golden():
    golden = np.load(FIXTURE)
    mt, _, configs = _port_mt(50)
    out, _ = mt.get_control(mt.initial_states(), _hairpins(50), v_max_runtime=_caps(configs))
    np.testing.assert_array_equal(out.solved.numpy(), golden["multi_track/solved"])
    for field in ("projected_control", "cum_time"):
        np.testing.assert_allclose(
            getattr(out, field).numpy(), golden[f"multi_track/{field}"], err_msg=field, **TOL
        )


def test_batched_equals_each_tracks_own_mpc(h16):
    mt, agent, configs, refs, caps, out, _ = h16
    assert bool(out.solved.all())
    for i, cfg in enumerate(configs):
        model = SpatialBicycleModel(
            agent[i].vehicle, cfg.constraints.v_min, cfg.constraints.v_max
        )
        single = SpatialMPC(cfg, model, device="cpu")
        s_out, _ = single.get_control(single.initial_state(), refs[i], caps[i])
        assert bool(s_out.solved)
        np.testing.assert_allclose(
            out.projected_control[i].numpy(), s_out.projected_control.numpy(),
            err_msg=TRACKS[i], **TOL,
        )


def test_grid_equals_track_axis_solves(h16):
    mt, _, _, _, caps, _, _ = h16
    S = 3
    refs = np.stack([_hairpins(16, extra=2 * s) for s in range(S)])
    out, diags = mt.get_control_grid(
        mt.initial_states(n_scenarios=S), refs, np.broadcast_to(caps, (S, len(TRACKS)))
    )
    assert out.projected_control.shape == (S, len(TRACKS), 2, 15)
    assert diags.control_status.shape == (S, len(TRACKS))
    assert int(out.solved.sum()) == S * len(TRACKS)
    for s in range(S):
        row, _ = mt.get_control(mt.initial_states(), refs[s], v_max_runtime=caps)
        # each scenario's iterates are its own in the batched engine
        # (finished ones freeze), so the grid repeats the rows' arithmetic
        np.testing.assert_allclose(
            out.projected_control[s].numpy(), row.projected_control.numpy(),
            rtol=1e-5, atol=1e-5,
        )


def test_grid_defaults_to_configured_caps(h16):
    mt = h16[0]
    refs = _hairpins(16)[None]
    out, _ = mt.get_control_grid(mt.initial_states(n_scenarios=1), refs)
    row, _ = mt.get_control(mt.initial_states(), refs[0])
    np.testing.assert_array_equal(out.projected_control[0].numpy(), row.projected_control.numpy())


def test_live_jax_multi_track_matches_port(h16):
    _, _, configs, refs, caps, out, _ = h16
    jagent = [jax_load_config(ROOT / "configs" / f"{t}.yaml") for t in TRACKS]
    jconfigs = [dataclasses.replace(c.racing_control, horizon=16) for c in jagent]
    model = JModel(jagent[0].vehicle, jconfigs[0].constraints.v_min, jconfigs[0].constraints.v_max)
    jm = jmt.MultiTrackMPC(JMPC(jconfigs[0], model), jconfigs)
    jout, _ = jm.get_control(jm.initial_states(), jnp.asarray(refs), v_max_runtime=jnp.asarray(caps))
    np.testing.assert_array_equal(out.solved.numpy(), np.asarray(jout.solved))
    for field in ("projected_control", "cum_time", "velocities"):
        np.testing.assert_allclose(
            getattr(out, field).numpy(), np.asarray(getattr(jout, field)), err_msg=field, **TOL
        )


def test_pack_track_params_matches_jax():
    _, configs = _configs(50)
    jconfigs = [
        dataclasses.replace(c.racing_control, horizon=50)
        for c in (jax_load_config(ROOT / "configs" / f"{t}.yaml") for t in TRACKS)
    ]
    ours = tmt.pack_track_params(configs)
    ref = jmt.pack_track_params(jconfigs)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # vallelunga has no end velocity; every other track has one
    has_end = dict(zip(TRACKS, ours["has_end_velocity"].tolist()))
    assert has_end.pop("vallelunga") == 0.0
    assert set(has_end.values()) == {1.0}


@pytest.mark.parametrize("seed", range(2))
def test_speed_profile_traced_matches_jax(seed):
    """Per-track constraint values through the (min,+) scan, on random
    windows and caps (vallelunga's missing end velocity among them)."""
    _, configs = _configs(50)
    p = tmt.pack_track_params(configs)
    rng = np.random.default_rng(seed)
    T, N = len(TRACKS), 49
    distances = rng.uniform(0.5, 2.5, (T, N)).astype(np.float32)
    kappas = rng.normal(0, 0.02, (T, N)).astype(np.float32)
    v_run = rng.uniform(8, 35, T).astype(np.float32)
    got = tmt._speed_profile_traced(
        torch.as_tensor(distances), torch.as_tensor(kappas), p, torch.as_tensor(v_run)
    )
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = jax.vmap(jmt._speed_profile_traced)(
        jnp.asarray(distances), jnp.asarray(kappas), jp, jnp.asarray(v_run)
    )
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    # slack sums in another order (as tests/test_torch_mpc.py's profile)
    np.testing.assert_allclose(
        got.velocities.numpy(), np.asarray(want.velocities), rtol=1e-5, atol=1e-4
    )


def test_horizon_mismatch_raises():
    _, configs = _configs(16)
    mt, _, _ = _port_mt(16)
    with pytest.raises(ValueError):
        tmt.MultiTrackMPC(mt.mpc, [dataclasses.replace(configs[0], horizon=20)])
