"""The port's particle filter against the JAX package's, one call at a time
(CPU), on the behaviours ``tests/test_localise.py`` covers.

Both filters start each call from the same state, carried across as
numpy (``convert.pf_state_from_numpy``), and the port's draws are the
numbers ``jax.random`` makes for the JAX state's key, in the JAX code's
order (``ScriptedDraws``). The JAX run goes on from its own result
(teacher forcing), so the chaotic filter cannot carry a rounding
difference into the next call. Tolerances: positions to 1e-4 m and yaw
to 1e-5 rad (fp32 on coordinates of a few hundred metres, summed in
another order); validity, nearest-map indices and the convergence flags
exactly, and so the resampling draws, since one moved draw moves a
particle by metres; weights to 5e-3 relative: the JAX update compiled
as one program differs from the same update run op by op by up to
1.9e-3 on a single weight (measured on the worm drive below), and the
port follows the op-by-op rounding.
"""

from __future__ import annotations

import dataclasses
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.config.schema import LocalisationConfig as JLocalisationConfig
from acmpc_tpu.localise import Localiser as JLocaliser
from acmpc_tpu.localise import PFConfig as JPFConfig
from acmpc_tpu.localise import ParticleFilter as JParticleFilter
from acmpc_tpu.localise import save_track_map as jax_save_track_map
from acmpc_tpu.localise.track_map import nearest_point as jax_nearest_point
from acmpc_tpu_torch.config.schema import LocalisationConfig
from acmpc_tpu_torch.convert import pf_state_from_numpy, pf_state_to_numpy, track_map_from_numpy
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.localise import Localiser, PFConfig, ParticleFilter, PFState
from acmpc_tpu_torch.localise.particle_filter import ScriptedDraws, reset_indices
from acmpc_tpu_torch.localise.track_map import nearest_point
from test_localise import _pad, make_asymmetric_map, observation_from_pose

N = 400
CFG = dict(n_particles=N, n_converged_particles=N, threshold_error=20.0, convergence_distance=50.0)
XY_ATOL, YAW_ATOL, SCORE_RTOL = 1e-4, 1e-5, 5e-3
FIELDS = [f.name for f in dataclasses.fields(PFState)]
WHEELBASE, V, DT = 2.65, 20.0, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jmap():
    return make_asymmetric_map()


@jax.jit
def _predict_draws(key):
    _, k1, k2 = jax.random.split(key, 3)
    return jax.random.normal(k1, (N,)), jax.random.normal(k2, (N,))


def _update_draws(key, n: int, seeding: bool, unseeded: bool):
    """The draws of one JAX update, in its order: with seeding on, the
    key splits once first, and an unseeded update draws the scan's
    uniform and normals; then the resample's uniform and normals."""
    out = []
    if seeding:
        key, seed_key = jax.random.split(key)
        if unseeded:
            k1, k2 = jax.random.split(seed_key)
            out += [("uniform", jax.random.uniform(k1)), ("normal", jax.random.normal(k2, (n, 3)))]
    _, _, resample_key = jax.random.split(key, 3)
    k1, k2 = jax.random.split(resample_key)
    return out + [("uniform", jax.random.uniform(k1)), ("normal", jax.random.normal(k2, (n, 3)))]


def to_port(jstate) -> PFState:
    return pf_state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in FIELDS}, "cpu")


def assert_state_matches(got: PFState, want, label: str = ""):
    g = pf_state_to_numpy(got)
    w = {f: np.asarray(getattr(want, f)) for f in FIELDS}
    for f in ("valid", "converged", "previously_converged", "seeded", "seed_obs_count"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f"{label} {f}")
    np.testing.assert_allclose(g["states"][:, :2], w["states"][:, :2], rtol=0, atol=XY_ATOL, err_msg=label)
    np.testing.assert_allclose(g["states"][:, 2], w["states"][:, 2], rtol=0, atol=YAW_ATOL, err_msg=label)
    np.testing.assert_allclose(g["scores"], w["scores"], rtol=SCORE_RTOL, atol=1e-12, err_msg=label)
    np.testing.assert_allclose(g["fit_error"], w["fit_error"], rtol=1e-5, err_msg=label)
    np.testing.assert_allclose(g["cand_shift_m"], w["cand_shift_m"], rtol=1e-6, err_msg=label)
    np.testing.assert_allclose(g["cand_logw"], w["cand_logw"], rtol=1e-4, atol=1e-3, err_msg=label)


class Pair:
    """The JAX filter and the port's on one config and map; each call runs
    both from the JAX state with the same draws and compares them."""

    def __init__(self, jmap, **overrides):
        cfg = {**CFG, **overrides}
        self.jpf = JParticleFilter(JPFConfig(**cfg), jmap, wheelbase=WHEELBASE)
        tmap = track_map_from_numpy({k: np.asarray(getattr(jmap, k)) for k in ("centre", "left", "right")}, "cpu")
        self.pf = ParticleFilter(PFConfig(**cfg), tmap, wheelbase=WHEELBASE)
        self._predict = jax.jit(self.jpf.predict)
        self._update = jax.jit(self.jpf.update)
        self.last = None  # the port's result of the last call

    def predict(self, jstate, delta: float, v: float = V, dt: float = DT):
        a, b = _predict_draws(jstate.key)
        draws = ScriptedDraws([("normal", a), ("normal", b)], "cpu")
        want = self._predict(jstate, jnp.float32(delta), jnp.float32(v), jnp.float32(dt))
        self.last = self.pf.predict(to_port(jstate), delta, v, dt, draws)
        assert len(draws) == 0
        assert_state_matches(self.last, want, "predict")
        return want

    def update(self, jstate, *obs, **kw):
        cfg = self.pf.config
        draws = ScriptedDraws(
            _update_draws(jstate.key, cfg.n_particles, cfg.seed_from_observation, not bool(jstate.seeded)), "cpu"
        )
        want = self._update(jstate, *obs, **kw)
        tobs = [torch.as_tensor(np.array(o)) for o in obs]
        tkw = {k: torch.as_tensor(np.array(v)) if v is not None else None for k, v in kw.items()}
        tkw = {k: (int(v) if v is not None and v.dim() == 0 else v) for k, v in tkw.items()}
        self.last = self.pf.update(to_port(jstate), *tobs[:4], draws, *[int(o) for o in tobs[4:]], **tkw)
        assert len(draws) == 0
        assert_state_matches(self.last, want, "update")
        return want

    def estimate(self, jstate) -> np.ndarray:
        got = self.pf.estimate(to_port(jstate)).numpy()
        want = np.asarray(self.jpf.estimate(jstate))
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=XY_ATOL)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=YAW_ATOL)
        return got


def _observe(pair: Pair, jstate, pose, n_points=40):
    left, right = observation_from_pose(pair.jpf.map, pose.astype(np.float32), n_points)
    P = pair.pf.config.max_observation_points
    return pair.update(jstate, *_pad(left, P), *_pad(right, P))


def _centre(jmap):
    return np.asarray(jmap.centre)


def _pose_at(centre, i):
    m = len(centre)
    p0, p1 = centre[i % m], centre[(i + 1) % m]
    return np.array([p0[0], p0[1], np.arctan2(p1[1] - p0[1], p1[0] - p0[0])], np.float64)


def _yaw_rate_delta(centre, i, step_pts, v=V):
    """The tyre angle of the true yaw rate from centreline index i over
    one step."""
    yaw = _pose_at(centre, i)[2]
    yaw2 = _pose_at(centre, i + step_pts)[2]
    dyaw = (yaw2 - yaw + np.pi) % (2 * np.pi) - np.pi
    return float(np.arctan(WHEELBASE * (dyaw / DT) / v))


def test_reset_indices_equal_jax_linspace():
    for m, n in ((1500, 400), (11734, 500), (45421, 500), (10, 3), (100, 1)):
        want = np.asarray(jnp.linspace(0, m - 3, n).astype(jnp.int32))
        np.testing.assert_array_equal(reset_indices(m, n), want)


def test_reset_seeds_along_centreline(jmap):
    pair = Pair(jmap)
    jstate = pair.jpf.reset(jax.random.PRNGKey(0))
    state = pair.pf.reset()
    assert_state_matches(state, jstate, "reset")
    assert state.states.shape == (N, 3)
    d, _ = nearest_point(state.states[:, :2], pair.pf.map.centre)
    assert float(d.max()) < 1.0
    assert not bool(state.converged)


def test_predict_moves_particles(jmap):
    pair = Pair(jmap)
    jstate = pair.jpf.reset(jax.random.PRNGKey(0))
    pair.predict(jstate, 0.0, 10.0, 0.1)
    move = torch.linalg.vector_norm(pair.last.states[:, :2] - pair.pf.reset().states[:, :2], dim=1)
    assert 0.5 < float(move.mean()) < 1.5


def test_update_nearest_indices_equal_jax(jmap):
    """The three nearest-map queries of update, on a cloud jittered off
    the centreline, return JAX's indices exactly."""
    pair = Pair(jmap)
    rng = np.random.default_rng(0)
    locs = np.asarray(pair.jpf.reset(jax.random.PRNGKey(0)).states[:, :2]) + rng.normal(0, 3, (N, 2))
    locs = locs.astype(np.float32)
    for name in ("centre", "left", "right"):
        jd, ji = jax_nearest_point(jnp.asarray(locs), getattr(jmap, name))
        td, ti = nearest_point(torch.as_tensor(locs), getattr(pair.pf.map, name))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=name)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5, err_msg=name)


def test_filter_converges_to_true_pose(jmap):
    pair = Pair(jmap, score_sigma=1.0, threshold_error=4.0, convergence_distance=30.0)
    jstate = pair.jpf.reset(jax.random.PRNGKey(1))
    centre = _centre(jmap)
    spacing = float(np.linalg.norm(centre[301] - centre[300]))
    step_pts = max(1, int(round(V * DT / spacing)))
    for k in range(100):
        i = 300 + k * step_pts
        pose = _pose_at(centre, i)
        jstate = _observe(pair, jstate, pose)
        jstate = pair.predict(jstate, _yaw_rate_delta(centre, i, step_pts))
    est = pair.estimate(jstate)
    assert np.linalg.norm(est[:2] - pose[:2]) < 20.0


@pytest.mark.parametrize("seeding", [False, True])
def test_population_collapse_triggers_reset(jmap, seeding):
    """A garbage observation inside the forward crop kills every particle:
    the blind whole-track reset, which also restarts the seeding scan."""
    pair = Pair(jmap, threshold_error=0.01, seed_from_observation=seeding)
    jstate = pair.jpf.reset(jax.random.PRNGKey(2))
    P = pair.pf.config.max_observation_points
    obs = np.stack([np.full((P,), 500.0), np.linspace(5.0, 45.0, P)], axis=1).astype(np.float32)
    mask = np.ones((P,), bool)
    pair.update(jstate, jnp.asarray(obs), jnp.asarray(mask), jnp.asarray(obs), jnp.asarray(mask))
    new = pair.last
    torch.testing.assert_close(new.states, pair.pf.reset().states, rtol=0, atol=0)
    assert bool(new.valid.all())
    assert not bool(new.seeded) and int(new.seed_obs_count) == 0


def test_kidnapped_filter_resets_and_recovers(jmap):
    """Converge, teleport the car to the far side of the circuit: validity
    collapses, the whole-track reset fires, and the filter converges
    again near the new pose. The truth follows the filter's own bicycle
    model under pure pursuit, as in the JAX test."""
    pair = Pair(jmap, score_sigma=1.0, threshold_error=3.0, convergence_distance=30.0, localised_max_error=2.5)
    jstate = pair.jpf.reset(jax.random.PRNGKey(3))
    centre = _centre(jmap)
    m = len(centre)
    spacing = float(np.linalg.norm(centre[301] - centre[300]))

    def pp_delta(pose):
        i0 = int(np.argmin(np.linalg.norm(centre - pose[:2], axis=1)))
        target = centre[(i0 + int(round(10.0 / spacing))) % m]
        dx, dy = target - pose[:2]
        alpha = (np.arctan2(dy, dx) - pose[2] + np.pi) % (2 * np.pi) - np.pi
        dist = max(np.linalg.norm(target - pose[:2]), 1e-6)
        return float(np.arctan(2 * WHEELBASE * np.sin(alpha) / dist))

    def drive(jstate, pose, n_steps, stop_when=None):
        for k in range(n_steps):
            jstate = _observe(pair, jstate, pose)
            if stop_when is not None and stop_when(pair.last):
                return jstate, pose, k
            delta = pp_delta(pose)
            jstate = pair.predict(jstate, delta)
            pose = pose + DT * np.array(
                [V * np.cos(pose[2]), V * np.sin(pose[2]), V * np.tan(delta) / WHEELBASE]
            )
        return jstate, pose, None

    jstate, pose_a, _ = drive(jstate, _pose_at(centre, 300), 100)
    assert bool(pair.last.converged), "the port never converged before the jump"
    est_a = pair.estimate(jstate)
    assert np.linalg.norm(est_a[:2] - pose_a[:2]) < 20.0

    def reset_fired(s: PFState):
        spread = float(torch.linalg.vector_norm(s.states[:, :2] - torch.as_tensor(est_a[:2]), dim=1).max())
        return (not bool(s.converged)) and spread > 100.0

    kidnap = int(np.argmin(np.linalg.norm(centre - est_a[:2], axis=1)) + m // 2)
    jstate, pose_k, reset_at = drive(jstate, _pose_at(centre, kidnap), 80, stop_when=reset_fired)
    assert reset_at is not None, "the kidnap never triggered a whole-track reset"
    jstate, pose_b, _ = drive(jstate, pose_k, 120)
    est_b = pair.estimate(jstate)
    assert bool(pair.last.converged) and np.linalg.norm(est_b[:2] - pose_b[:2]) < 20.0


def test_spread_gated_sharpening_collapses_alongtrack_worm(jmap):
    """A ~100 m along-track worm under the broad sigma: with the basin gate
    (150 m) the port converges on the truth, without it (0 m) it does
    not, each call equal to JAX's."""
    centre = _centre(jmap)
    m = len(centre)
    spacing = float(np.linalg.norm(centre[1] - centre[0]))
    step_pts = max(1, int(round(V * DT / spacing)))

    def run(pair):
        jstate = pair.jpf.reset(jax.random.PRNGKey(7))
        half = int(50.0 / spacing)
        idx = (200 + np.round(np.linspace(-half, half, N)).astype(int)) % m
        p0, p1 = centre[idx], centre[(idx + 1) % m]
        yaw = np.arctan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
        jstate = jstate.replace(
            states=jnp.asarray(np.concatenate([p0, yaw[:, None]], axis=1), jnp.float32),
            seeded=jnp.asarray(True),
        )
        for k in range(120):
            i = 200 + k * step_pts
            pose = _pose_at(centre, i)
            jstate = _observe(pair, jstate, pose)
            jstate = pair.predict(jstate, _yaw_rate_delta(centre, i, step_pts))
        return jstate, pose

    gated = Pair(jmap, score_sigma=10.0)
    jstate, pose = run(gated)
    assert bool(gated.last.converged), "basin-gated sharpening never collapsed the worm"
    assert np.linalg.norm(gated.estimate(jstate)[:2] - pose[:2]) < 10.0
    ungated = Pair(jmap, score_sigma=10.0, sharpen_spread_m=0.0)
    run(ungated)
    assert not bool(ungated.last.converged)


def _facade_cfg(cls, **kw):
    base = dict(
        use_localisation=True, n_particles=N, n_converged_particles=N, sampling_noise_xy=1.1,
        sampling_noise_yaw_deg=3.0, control_noise_velocity=0.25, control_noise_yaw_deg=2.0,
        threshold_offset=10, threshold_rotation_deg=90, threshold_minimum_particles=20,
        threshold_track_limit=4.0, score_mean=0, score_sigma=1.0, convergence_max_distance=50,
        convergence_max_angle_deg=90,
    )
    return cls(**{**base, **kw})


def _facade_pair(jmap, tmp_path, **kw):
    jax_save_track_map(tmp_path / "map.npz", jmap.centre, jmap.left, jmap.right)
    path = str(tmp_path / "map.npz")
    jloc = JLocaliser(_facade_cfg(JLocalisationConfig, **kw), path)
    loc = Localiser(_facade_cfg(LocalisationConfig, **kw), path, device="cpu", draws=ScriptedDraws([], "cpu"))
    return jloc, loc


@pytest.mark.parametrize("centreline", [False, True])
def test_localiser_facade_roundtrip(jmap, tmp_path, centreline):
    """The facades side by side over 100 steps, the port's state set to
    the JAX one before each call and its draws JAX's: every observation
    and step agrees, and the port's estimate and map index land on the
    truth."""
    jloc, loc = _facade_pair(jmap, tmp_path, score_centreline=centreline)
    n = N
    centre = _centre(jmap)
    m = len(centre)
    spacing = float(np.linalg.norm(centre[701] - centre[700]))
    step_pts = max(1, int(round(V * DT / spacing)))
    v = step_pts * spacing / DT
    veh = VehicleParams()
    for k in range(100):
        i = 700 + k * step_pts
        pose = _pose_at(centre, i).astype(np.float32)
        left, right = observation_from_pose(jmap, pose)
        loc._state = to_port(jloc._state)
        loc._draws.extend(_update_draws(jloc._state.key, n, False, False))
        jloc.observe_tracklimits(left, right)
        loc.observe_tracklimits(left, right)
        assert_state_matches(loc._state, jloc._state, f"observe {k}")
        steering = -_yaw_rate_delta(centre, i, step_pts, v) / veh.max_steering_angle
        loc._state = to_port(jloc._state)
        loc._draws.extend([("normal", d) for d in _predict_draws(jloc._state.key)])
        jloc.step((steering, 0.0, v), dt=DT)
        loc.step((steering, 0.0, v), dt=DT)
        assert_state_matches(loc._state, jloc._state, f"step {k}")
    assert loc.is_localised == jloc.is_localised
    est = loc.estimated_position
    np.testing.assert_allclose(est[:2], jloc.estimated_position[:2], rtol=0, atol=XY_ATOL)
    assert np.linalg.norm(est[:2] - pose[:2]) < 25.0
    assert loc.estimated_map_index == jloc.estimated_map_index
    di = abs(loc.estimated_map_index - (700 + 99 * step_pts) % m)
    assert min(di, m - di) < 60


def test_nearest_point_exact_at_km_scale_coordinates():
    """The fp32 expansion cancels at km-scale coordinates; the windowed
    refine returns the fp64 nearest neighbour, as JAX's does."""
    rng = np.random.default_rng(0)
    theta = np.linspace(0, 2 * np.pi, 4000, endpoint=False)
    poly = np.stack([950.0 + 320.0 * np.cos(theta), -780.0 + 320.0 * np.sin(theta)], 1).astype(np.float32)
    probes = (poly[rng.integers(0, len(poly), 64)] + rng.uniform(-15, 15, (64, 2))).astype(np.float32)
    d64 = np.linalg.norm(poly[None].astype(np.float64) - probes[:, None].astype(np.float64), axis=2)
    dist, idx = nearest_point(torch.as_tensor(probes), torch.as_tensor(poly))
    np.testing.assert_array_equal(idx.numpy(), d64.argmin(1))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_nearest_point(jnp.asarray(probes), jnp.asarray(poly))[1]))
    np.testing.assert_allclose(dist.numpy(), d64.min(1), rtol=1e-4, atol=1e-3)


def test_prepare_aligns_sparse_far_to_near_observation(jmap):
    """A sparse far-to-near boundary starting metres ahead: ``_prepare``
    resamples it near-to-far at the map spacing with JAX's offset, and the
    update with that offset keeps the true-pose particle the best of
    eight against decoys 20-140 m ahead."""
    kw = dict(n_particles=8, n_converged_particles=8, threshold_minimum_particles=1,
              threshold_track_limit=20.0, score_sigma=10.0)
    tmp = pathlib.Path(tempfile.mkdtemp())
    jloc, loc = _facade_pair(jmap, tmp, **kw)
    centre = _centre(jmap)
    i0 = 700
    pose = _pose_at(centre, i0).astype(np.float32)
    full_l, full_r = observation_from_pose(jmap, pose, n_points=80)

    def sparsify(obs):
        keep = (obs[:, 1] > 6.0) & (obs[:, 1] < 60.0)
        return obs[keep][::4][::-1].copy()

    prepared = {}
    for side, full in (("left", full_l), ("right", full_r)):
        ol, ml, s0 = loc._prepare(sparsify(full))
        jol, jml, js0 = jloc._prepare(sparsify(full))
        assert s0 == int(js0) and s0 >= 5
        np.testing.assert_array_equal(ml.numpy(), np.asarray(jml))
        np.testing.assert_allclose(ol.numpy(), np.asarray(jol), rtol=0, atol=1e-5)
        pts = ol.numpy()[ml.numpy()]
        assert pts[0, 1] < pts[-1, 1]
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1).mean()
        assert abs(seg - loc._avg_spacing) < 0.25 * loc._avg_spacing
        prepared[side] = (jol, jml, js0)

    yaw = pose[2]
    decoys = np.stack([np.concatenate([centre[(i0 + 40 * (k + 1)) % len(centre)], [yaw]]) for k in range(7)])
    states = np.vstack([pose[None, :], decoys]).astype(np.float32)
    pair = Pair(jmap, **{**PFConfig.from_config(_facade_cfg(LocalisationConfig, **kw)).__dict__})
    jstate = pair.jpf.reset(jax.random.PRNGKey(0)).replace(
        states=jnp.asarray(states), scores=jnp.full((8,), 1.0 / 8), valid=jnp.ones((8,), bool),
        seeded=jnp.asarray(True),
    )
    (jol, jml, js0), (jor, jmr, js0r) = prepared["left"], prepared["right"]
    pair.update(jstate, jol, jml, jor, jmr, js0, js0r)
    assert int(torch.argmax(pair.last.scores)) == 0


def test_seeding_scan_concentrates_near_observed_basin(jmap):
    """With the seeding scan on, eight frames from a static pose each equal
    JAX's, and the draw on the last puts a real share of the population
    near the truth while the uniform floor keeps far basins."""
    pair = Pair(jmap, seed_from_observation=True)
    jstate = pair.jpf.reset(jax.random.PRNGKey(0))
    pose = _pose_at(_centre(jmap), 700)
    for k in range(pair.pf.config.seed_scan_frames):
        assert not bool(jstate.seeded), f"seeded early at frame {k}"
        jstate = _observe(pair, jstate, pose, n_points=60)
    state = pair.last
    assert bool(state.seeded) and int(state.seed_obs_count) == 0
    d_true = np.linalg.norm(state.states[:, :2].numpy() - pose[:2], axis=1)
    assert float((d_true < 100.0).mean()) > 0.15
    assert float((d_true > 300.0).mean()) > 0.02


def _tight_cloud(pair, jmap, far_weight=None):
    centre = _centre(jmap)
    states = np.tile(np.array([centre[100, 0], centre[100, 1], 0.0], np.float32), (N, 1))
    weights = np.full((N,), 1.0, np.float32)
    if far_weight is not None:
        states[-8:] = [centre[900, 0], centre[900, 1], 0.0]
        weights[-8:] = far_weight
    weights /= weights.sum()
    return pair.jpf.reset(jax.random.PRNGKey(0)).replace(
        states=jnp.asarray(states), scores=jnp.asarray(weights), valid=jnp.ones((N,), bool),
        fit_error=jnp.asarray(0.5, jnp.float32),
    )


def _convergence(pair, jstate) -> bool:
    got = pair.pf._update_convergence(to_port(jstate))
    assert_state_matches(got, pair.jpf._update_convergence(jstate), "convergence")
    return bool(got.converged)


def test_mass_convergence_ignores_low_weight_aliases(jmap):
    mass = Pair(jmap, localised_max_error=0.0)
    state = _tight_cloud(mass, jmap, far_weight=1e-4)
    assert _convergence(mass, state)
    spread = Pair(jmap, localised_max_error=0.0, convergence_mass=0.0)
    assert not _convergence(spread, state)


def test_fit_gate_blocks_displaced_lock(jmap):
    pair = Pair(jmap, localised_max_error=5.0)
    state = _tight_cloud(pair, jmap)
    assert _convergence(pair, state.replace(fit_error=jnp.asarray(1.0, jnp.float32)))
    assert not _convergence(pair, state.replace(fit_error=jnp.asarray(11.0, jnp.float32)))


def test_forced_resample_and_estimate_equal_jax(jmap):
    """``_resample`` on its own, with ESS collapse forcing every slot to
    be drawn, and on a cloud with dead slots to refill; then ``estimate``."""
    pair = Pair(jmap)
    rng = np.random.default_rng(1)
    base = pair.jpf.reset(jax.random.PRNGKey(4))
    states = np.asarray(base.states) + rng.normal(0, [2.0, 2.0, 0.05], (N, 3)).astype(np.float32)
    for dead in (0, 150):
        weights = rng.gamma(0.3, size=N).astype(np.float32)
        valid = np.arange(N) >= dead
        weights = np.where(valid, weights, 0.0).astype(np.float32)
        weights /= weights.sum()
        jstate = base.replace(states=jnp.asarray(states, jnp.float32), scores=jnp.asarray(weights),
                              valid=jnp.asarray(valid))
        key = jax.random.PRNGKey(dead)
        k1, k2 = jax.random.split(key)
        draws = ScriptedDraws([("uniform", jax.random.uniform(k1)), ("normal", jax.random.normal(k2, (N, 3)))], "cpu")
        n_valid, e_min = int(valid.sum()), 1.5
        want = pair.jpf._resample(jstate, key, jnp.asarray(n_valid, jnp.int32), jnp.float32(e_min))
        got = pair.pf._resample(to_port(jstate), draws, torch.tensor(n_valid), torch.tensor(e_min))
        assert_state_matches(got, want, f"resample dead={dead}")
        pair.estimate(want)
