"""The port's localiser facade and localisation config against the JAX
package's (CPU), at the shipped operating point: the configs' 500
particles and 256 observation points on the shipped maps, the committed
recordings, and the port's perception feeding the filter as the agent
does.

Tolerances are those of ``test_torch_localise.py``; the host
preparation of an observation is bit-equal once both facades use the
same map spacing (the two libraries' fp32 means of the segment lengths
differ in the last bit, which is checked separately).
"""

from __future__ import annotations

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.localise import Localiser as JLocaliser
from acmpc_tpu.localise import PFConfig as JPFConfig
from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.config.schema import LocalisationConfig
from acmpc_tpu_torch.localise import Localiser, PFConfig
from acmpc_tpu_torch.localise.benchmarking import LocalisationRecording
from acmpc_tpu_torch.localise.particle_filter import ScriptedDraws
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from test_torch_localise import XY_ATOL, YAW_ATOL, _predict_draws, _update_draws, assert_state_matches, to_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRACKS = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))
RECORDED_OBSERVATIONS = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _localisers(track: str, draws=True):
    """(JAX, port) localisers on the track's shipped config and map; the
    port's on the CPU, taking scripted draws."""
    path = str(ROOT / "data" / "maps" / f"{track}.npz")
    jcfg = j_load_config(ROOT / "configs" / f"{track}.yaml")
    cfg = load_config(ROOT / "configs" / f"{track}.yaml")
    jloc = JLocaliser(jcfg.localisation, path, vehicle=jcfg.vehicle)
    loc = Localiser(cfg.localisation, path, vehicle=cfg.vehicle, device="cpu",
                    draws=ScriptedDraws([], "cpu") if draws else None)
    return jloc, loc


@pytest.mark.parametrize("track", TRACKS)
def test_localisation_config_equals_jax(track):
    path = ROOT / "configs" / f"{track}.yaml"
    ours, ref = load_config(path).localisation, j_load_config(path).localisation
    assert isinstance(ours, LocalisationConfig)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PFConfig.from_config(ours)) == dataclasses.asdict(JPFConfig.from_config(ref))
    if track == "monza":
        assert ours.localised_max_error == 2.5


def test_missing_map_raises():
    cfg = load_config(ROOT / "configs" / "monza.yaml").localisation
    with pytest.raises(FileNotFoundError):
        Localiser(cfg, str(ROOT / "data" / "maps" / "no_such_map.npz"), device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = load_config(ROOT / "configs" / "monza.yaml").localisation
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Localiser(cfg, str(ROOT / "data" / "maps" / "monza.npz"))


@pytest.mark.parametrize("recording", ["monza_realperc", "monza_synth", "nordschleife_synth"])
def test_normalise_and_pad_bit_equal_to_jax(recording):
    track = recording.rsplit("_", 1)[0]
    jloc, loc = _localisers(track)
    # one fp32 mean of ~10^4 segment lengths in two libraries
    np.testing.assert_allclose(loc._avg_spacing, jloc._avg_spacing, rtol=3e-7)
    loc._avg_spacing = jloc._avg_spacing
    rec = LocalisationRecording(str(ROOT / "data" / "localisation" / recording / "racing"))
    observations = [r["tracklimits"] for r in rec if "tracklimits" in r][:RECORDED_OBSERVATIONS]
    resampled = 0
    for obs in observations:
        for side in ("left", "right"):
            got, start = loc._normalise(obs[side])
            want, jstart = jloc._normalise(obs[side])
            assert start == jstart
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            resampled += len(got) != len(obs[side])
            padded, mask = loc._pad(got)
            jpadded, jmask = jloc._pad(want)
            np.testing.assert_array_equal(padded, np.asarray(jpadded))
            np.testing.assert_array_equal(mask, np.asarray(jmask))
    if recording == "monza_realperc":  # sparse perceived chains: regridded
        assert resampled > 0


def _lockstep(jloc, loc, records, label):
    """Replay ``records`` through both facades: before each call the port
    takes the JAX state and the draws JAX makes for its key; after it the
    two states must agree."""
    n = loc._pf_config.n_particles
    steps = observations = 0
    last_time = None
    for record in records:
        loc._state = to_port(jloc._state)
        if "control_command" in record:
            dt = 0.0 if last_time is None else record["time"] - last_time
            last_time = record["time"]
            loc._draws.extend([("normal", d) for d in _predict_draws_n(jloc._state.key, n)])
            jloc.step(record["control_command"], dt=dt)
            loc.step(record["control_command"], dt=dt)
            steps += 1
        else:
            obs = record["tracklimits"]
            loc._draws.extend(_update_draws(jloc._state.key, n, False, False))
            jloc.observe_tracklimits(obs["left"], obs["right"])
            loc.observe_tracklimits(obs["left"], obs["right"])
            observations += 1
        assert len(loc._draws) == 0
        assert_state_matches(loc._state, jloc._state, f"{label} record {steps + observations}")
    return steps, observations


def _predict_draws_n(key, n):
    if n == 400:
        return _predict_draws(key)
    _, k1, k2 = jax.random.split(key, 3)
    return jax.random.normal(k1, (n,)), jax.random.normal(k2, (n,))


def test_facade_with_injected_draws_on_a_recording():
    """The shipped monza filter (500 particles) on the first records of
    the real-perception recording, call by call; then the readers."""
    jloc, loc = _localisers("monza")
    rec = LocalisationRecording(str(ROOT / "data" / "localisation" / "monza_realperc" / "racing"))
    steps, observations = _lockstep(jloc, loc, list(rec)[:60], "monza_realperc")
    assert steps > 0 and observations > 0
    assert loc.is_localised == jloc.is_localised
    est, jest = loc.estimated_position, jloc.estimated_position
    np.testing.assert_allclose(est[:2], jest[:2], rtol=0, atol=XY_ATOL)
    np.testing.assert_allclose(est[2], jest[2], rtol=0, atol=YAW_ATOL)
    assert loc.estimated_map_index == jloc.estimated_map_index
    np.testing.assert_allclose(loc.particle_states, np.asarray(jloc.particle_states), rtol=0, atol=XY_ATOL)
    # a reset goes back to the blind prior and to seeded torch draws
    loc.reset(seed=3)
    jloc.reset(seed=3)
    assert_state_matches(loc._state, jloc._state, "reset")


def test_perceiver_raw_points_feed_both_filters():
    """The agent's feed: the port's Perceiver on the shipped checkpoint at
    320x192 sees the sim's frame at a few monza poses, and the masked raw
    boundary points go through ``observe_tracklimits`` of both filters."""
    cfg = dataclasses.replace(loop.perception_config(320, 192), precision="fp32")
    perc = Perceiver(cfg, device="cpu")
    tm = load_track_map(ROOT / "data" / "maps" / "monza.npz", device="cpu")
    sim = SyntheticSimulator(tm, CameraInfo.from_config(cfg), half_width=5.0)
    jloc, loc = _localisers("monza")
    n = loc._pf_config.n_particles
    centre = tm.centre.numpy()
    seen = 0
    for i in (50, 2000, 6000):
        p0, p1 = centre[i], centre[i + 1]
        sim.x, sim.y = float(p0[0]), float(p0[1])
        sim.yaw = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0]))
        out = perc.perceive(sim.render_camera_image(sim.render_drivable_mask()))
        left = out["left_raw"].numpy()[out["left_raw_mask"].numpy()]
        right = out["right_raw"].numpy()[out["right_raw_mask"].numpy()]
        seen += min(len(left), len(right))
        loc._state = to_port(jloc._state)
        loc._draws.extend(_update_draws(jloc._state.key, n, False, False))
        jloc.observe_tracklimits(left, right)
        loc.observe_tracklimits(left, right)
        assert_state_matches(loc._state, jloc._state, f"pose {i}")
    assert seen > 0, "perception saw no boundary points"
