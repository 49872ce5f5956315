"""Track maps: the port's loader and nearest-neighbour query against the
JAX package's on the same files and points (CPU)."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.localise.track_map import (
    TrackMap as JTrackMap,
    load_track_map as jax_load_track_map,
    nearest_point as jax_nearest_point,
)
from acmpc_tpu_torch.convert import track_map_from_numpy
from acmpc_tpu_torch.localise.track_map import (
    TrackMap,
    _remove_near_duplicates,
    load_track_map,
    nearest_point,
    save_track_map,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("centre", "left", "right")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # one intra-op thread per test worker: the parallel run shares the cores
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_nearest():
    return jax.jit(jax_nearest_point, static_argnames="refine")


def _assert_maps_equal(ours: TrackMap, ref: JTrackMap):
    for f in FIELDS:
        got, want = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype == np.float32, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _json_map(tmp_path):
    rng = np.random.default_rng(0)
    pts = np.cumsum(rng.normal(size=(3, 50, 2)), axis=1)
    pts[:, 10] = pts[:, 9]  # a duplicate point the loader drops
    path = tmp_path / "map.json"
    path.write_text(json.dumps({
        "Outside": pts[0].tolist(), "Inside": pts[1].tolist(), "Centre": pts[2].tolist(),
    }))
    return path


@pytest.mark.parametrize(
    "name", ["maps/synth_nordschleife.npy", "maps/monza.npz", "json"]
)
def test_load_track_map_bit_equal_to_jax(name, tmp_path):
    path = _json_map(tmp_path) if name == "json" else ROOT / "data" / name
    ours = load_track_map(path, device="cpu")
    _assert_maps_equal(ours, jax_load_track_map(path))
    assert ours.n_centre == int(jax_load_track_map(path).centre.shape[0])


def test_save_load_round_trip_and_spacing(tmp_path):
    tm = load_track_map(ROOT / "data" / "maps" / "monza.npz", device="cpu")
    save_track_map(tmp_path / "m.npz", tm.centre, tm.left, tm.right)
    again = load_track_map(tmp_path / "m.npz", device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(again, f), getattr(tm, f))
    ref = jax_load_track_map(ROOT / "data" / "maps" / "monza.npz")
    # fp32 norms and a mean over ~10^4 segments in two libraries
    np.testing.assert_allclose(
        float(tm.average_spacing), float(ref.average_spacing), rtol=1e-5
    )


def test_remove_near_duplicates():
    pts = np.array([[0, 0], [0, 0], [1, 0], [1, 5e-5], [2, 0]], np.float32)
    np.testing.assert_array_equal(_remove_near_duplicates(pts), pts[[0, 2, 4]])
    assert len(_remove_near_duplicates(pts[:1])) == 1


def _km_polyline(m=3000):
    """An open curve of 0.5 m steps far from the origin (km-scale
    coordinates, where the coarse |p|^2 - 2 p.m + |m|^2 cancels)."""
    s = 0.5 * np.arange(m)
    xy = np.stack([s, 40.0 * np.sin(s / 60.0) + 0.002 * s**1.5], axis=1)
    return (xy + np.array([4200.0, -3100.0])).astype(np.float32)


def _query_points(polyline, k, seed):
    rng = np.random.default_rng(seed)
    near = polyline[rng.integers(0, len(polyline), k)] + rng.uniform(-6, 6, (k, 2))
    # beyond both open ends of the polyline
    d0 = polyline[0] - polyline[1]
    d1 = polyline[-1] - polyline[-2]
    ends = np.concatenate([
        polyline[0] + d0 * rng.uniform(2, 100, (8, 1)),
        polyline[-1] + d1 * rng.uniform(2, 100, (8, 1)),
    ])
    return np.concatenate([near, ends]).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_nearest_point_matches_jax_at_km_scale(seed, jax_nearest):
    polyline = _km_polyline()
    points = _query_points(polyline, 200, seed)
    dist, idx = nearest_point(torch.as_tensor(points), torch.as_tensor(polyline))
    jdist, jidx = jax_nearest(jnp.asarray(points), jnp.asarray(polyline), refine=32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # the refine stage's exact fp32 differences on both sides
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=1e-4)
    # and the true nearest neighbour, from float64 brute force
    d64 = np.linalg.norm(points[:, None].astype(np.float64) - polyline[None], axis=-1)
    np.testing.assert_allclose(dist.numpy(), d64.min(axis=1), rtol=0, atol=1e-3)


def test_nearest_point_batched_on_shipped_map(jax_nearest):
    tm = load_track_map(ROOT / "data" / "maps" / "synth_nordschleife.npy", device="cpu")
    centre = tm.centre.numpy()
    rng = np.random.default_rng(5)
    points = (centre[rng.integers(0, len(centre), (3, 40))] + rng.normal(0, 3, (3, 40, 2)))
    points = points.astype(np.float32)
    dist, idx = nearest_point(torch.as_tensor(points), tm.centre)
    jdist, jidx = jax_nearest(jnp.asarray(points), jnp.asarray(centre), refine=32)
    assert idx.shape == dist.shape == (3, 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=1e-4)


def test_track_map_from_numpy_and_default_device():
    arrays = {f: np.zeros((4, 2), np.float32) for f in FIELDS}
    tm = track_map_from_numpy(arrays, device="cpu")
    assert all(getattr(tm, f).device.type == "cpu" for f in FIELDS)
    if not torch.cuda.is_available():
        # an entry point: CUDA unless the caller names the CPU, no fallback
        with pytest.raises(RuntimeError):
            load_track_map(ROOT / "data" / "maps" / "monza.npz")
