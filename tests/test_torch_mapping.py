"""The port's map maker and its C++ tour against the JAX package's (CPU).

The map maker is host numpy in both packages, so its steps agree to
1e-9 (float64 arithmetic in the same order) on the simulated mapping lap
of tests/test_mapping.py. The tour is the port's own build of its copy of
the C++ source; it is held to JAX's numpy tour and to its own numpy twin
on the shuffled loop of tests/test_mapping.py: tour length within 1%, and
the same order, since all three 2-opts converge well inside the bound.
"""

import pathlib

import numpy as np
import pytest
import torch

from acmpc_tpu.localise.track_map import load_track_map as j_load_track_map
from acmpc_tpu.mapping import map_maker as jmm
from acmpc_tpu.native import _tsp_tour_numpy as j_tsp_tour_numpy
from acmpc_tpu_torch import native
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.mapping import map_maker as pmm
from acmpc_tpu_torch.ops import cuda_build
from test_mapping import simulate_mapping_lap

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shuffled_loop():
    """tests/test_mapping.py's 200-point noisy ellipse, shuffled."""
    rng = np.random.default_rng(1)
    theta = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    loop = np.stack([100 * np.cos(theta), 80 * np.sin(theta)], axis=1)
    loop += rng.normal(scale=0.3, size=loop.shape)
    perm = rng.permutation(200)
    return loop[perm]


def _tour_length(points, order):
    ordered = points[order]
    return np.linalg.norm(np.diff(np.vstack([ordered, ordered[:1]]), axis=0), axis=1).sum()


def _replay_frames(n_frames=400):
    """The per-frame inputs of ``simulate_mapping_lap``, fed to both map
    makers' ``process_segmentation_tracks``."""
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    r = 150.0 + 20.0 * np.sin(2 * theta)
    centre = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    d = np.roll(centre, -1, axis=0) - centre
    t = d / np.linalg.norm(d, axis=1, keepdims=True)
    normal = np.stack([-t[:, 1], t[:, 0]], axis=1)
    left = centre + 5.0 * normal
    right = centre - 5.0 * normal
    for i in range(n_frames):
        yaw = np.arctan2(t[i, 1], t[i, 0])
        pose = {"x": -centre[i, 0], "z": centre[i, 1], "translation_yaw": yaw}
        rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
        bev_left = (rot @ (left[i] - centre[i]).reshape(1, 2).T).T
        bev_right = (rot @ (right[i] - centre[i]).reshape(1, 2).T).T
        yield pose, bev_left, bev_right, np.zeros((1, 2))


@pytest.fixture(scope="module")
def makers():
    jmaker, pmaker = jmm.MapMaker(), pmm.MapMaker()
    for frame in _replay_frames():
        jmaker.process_segmentation_tracks(*frame)
        pmaker.process_segmentation_tracks(*frame)
    return jmaker, pmaker


def _trimmed(maker):
    t = pmm.TRIM_STATIONARY
    return (
        maker._flatten_nearest(maker.inside_track)[t:-t],
        maker._flatten_nearest(maker.outside_track)[t:-t],
    )


def test_accumulation_equals_jax(makers):
    jmaker, pmaker = makers
    want, _ = simulate_mapping_lap()
    for name in ("xy_points_driven", "outside_track", "inside_track", "centre_track"):
        got, ref = getattr(pmaker, name), getattr(jmaker, name)
        assert len(got) == len(ref) == 400
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=name)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("closed", [True, False])
def test_savgol_wrap_equals_jax(makers, closed):
    _, pmaker = makers
    inside, _ = _trimmed(pmaker)
    for column in (0, 1):
        np.testing.assert_allclose(
            pmm.savgol_wrap(inside[:, column], closed=closed),
            jmm.savgol_wrap(inside[:, column], closed=closed),
            **TOL,
        )


def test_track_steps_equal_jax(makers):
    _, pmaker = makers
    inside, outside = _trimmed(pmaker)
    for track in (inside, outside):
        np.testing.assert_allclose(pmm.upsample_track(track), jmm.upsample_track(track), **TOL)
        np.testing.assert_allclose(pmm.resample_uniform(track), jmm.resample_uniform(track), **TOL)
        np.testing.assert_allclose(pmm.remove_folds(track), jmm.remove_folds(track), **TOL)
    # a fold: the polyline doubles back, and both drop the same points
    folded = np.concatenate([inside[:50], inside[48:46:-1], inside[47:120]])
    np.testing.assert_allclose(pmm.remove_folds(folded), jmm.remove_folds(folded), **TOL)
    assert len(pmm.remove_folds(folded)) < len(folded)
    assert pmm._is_closed(inside) == jmm._is_closed(inside)


def test_build_map_equals_jax(makers):
    jmaker, pmaker = makers
    inside, outside = _trimmed(pmaker)
    got = pmaker.build_map(inside, outside)
    want = jmaker.build_map(inside, outside)
    assert set(got) == set(want) == {"outside_track", "inside_track", "centre_track"}
    for key in got:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_save_map_reads_back_in_both_packages(tmp_path):
    pmaker = pmm.MapMaker()
    for frame in _replay_frames():
        pmaker.process_segmentation_tracks(*frame)
    out = str(tmp_path / "self_map.npy")
    built = pmaker.save_map(out)
    assert pmaker.map_built
    assert (tmp_path / "self_map-raw-points.npy").exists()
    raw = np.load(tmp_path / "self_map-raw-points.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(raw["insides"], _trimmed(pmaker)[0])
    ours = load_track_map(out, device="cpu")
    ref = j_load_track_map(out)
    for name, key in (("centre", "centre_track"), ("left", "outside_track"), ("right", "inside_track")):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
        assert len(getattr(ours, name)) <= len(built[key])


def test_tsp_tour_equals_jax_numpy_tour():
    points = np.float32(_shuffled_loop())
    ours = native.tsp_tour(points, time_bound_s=3.0)
    twin = native._tsp_tour_numpy(points, 3.0)
    ref = j_tsp_tour_numpy(points, 3.0)
    assert ours.dtype == np.int64 and sorted(ours) == list(range(200))
    length = _tour_length(points, ours)
    assert abs(length - _tour_length(points, ref)) <= 0.01 * _tour_length(points, ref)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(twin, ref)
    # and the tour is the loop: close to its circumference
    rng = np.random.default_rng(1)
    theta = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    loop = np.stack([100 * np.cos(theta), 80 * np.sin(theta)], axis=1) + rng.normal(scale=0.3, size=(200, 2))
    assert length < 1.25 * _tour_length(loop, np.arange(200))


def test_tsp_tour_small_inputs():
    assert native.tsp_tour(np.zeros((0, 2))).tolist() == []
    assert native.tsp_tour(np.zeros((2, 2))).tolist() == [0, 1]
    order = native.tsp_tour(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.5, 0.0]]), 1.0)
    assert sorted(order.tolist()) == [0, 1, 2, 3, 4]


def test_tsp_build_is_the_ports_own():
    lib = native._library()
    path = pathlib.Path(lib._name)
    assert path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("tsp_tour-host-") and path.with_suffix(".log").exists()
    assert "acmpc_tpu/native" not in str(path)


def test_tsp_build_without_compiler_raises(monkeypatch):
    monkeypatch.setattr(cuda_build, "HOST_CXX", "/nonexistent/c++")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler"):
            native.tsp_tour(np.float32(_shuffled_loop()), 1.0)
    finally:
        native._library.cache_clear()
