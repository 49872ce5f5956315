"""The port's offline CLIs on the CPU: the raceline calculator, the map
viewer and the localisation benchmark (with its 9-panel figure), each
against what the library computes and the JAX tests' bounds
(tests/test_tools.py). Each CLI runs on the card unless ``--device``
names another device."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.cli import benchmark_localisation, raceline, view_map
from acmpc_tpu_torch.localise.track_map import save_track_map
from acmpc_tpu_torch.utils.raceline import calculate_raceline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small_map(tmp_path_factory):
    """tests/test_localise.py's asymmetric loop at 300 points, as .npz."""
    from test_localise import make_asymmetric_map

    tm = make_asymmetric_map(300)
    path = tmp_path_factory.mktemp("maps") / "loop.npz"
    save_track_map(path, np.asarray(tm.centre), np.asarray(tm.left), np.asarray(tm.right))
    return path, tm


def test_raceline_cli_writes_what_calculate_raceline_returns(small_map, tmp_path, capsys):
    path, tm = small_map
    out, plot = tmp_path / "line.npy", tmp_path / "line.png"
    line = raceline.main(["--map", str(path), "--out", str(out), "--plot", str(plot), "--device", "cpu"])
    written = np.load(out)
    np.testing.assert_array_equal(written, line)
    centre, half = raceline.corridor(np.asarray(tm.centre), np.asarray(tm.left), 1)
    np.testing.assert_array_equal(written, calculate_raceline(centre, half, device="cpu"))
    assert written.shape == (300, 2) and plot.stat().st_size > 10_000
    assert "wrote raceline with 300 points" in capsys.readouterr().out


def test_raceline_cli_caps_the_point_count():
    assert raceline.cap_stride(586) == 1 and raceline.cap_stride(600) == 1
    assert raceline.cap_stride(11714) == 20 and len(np.zeros(11714)[::20]) == 586
    # the nearest left-boundary point sets the half width
    centre = np.array([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0]])
    left = np.array([[0.0, 3.0], [10.0, 4.0], [20.0, 5.0], [30.0, 0.5]])
    c, half = raceline.corridor(centre, left, 2)
    np.testing.assert_array_equal(c, centre[::2])
    np.testing.assert_allclose(half, [3.0, 5.0])


def test_raceline_plot_raises_without_matplotlib(small_map, tmp_path, monkeypatch):
    path, _ = small_map
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        raceline.main(["--map", str(path), "--out", str(tmp_path / "l.npy"),
                       "--plot", str(tmp_path / "l.png"), "--device", "cpu"])
    assert (tmp_path / "l.npy").exists() and not (tmp_path / "l.png").exists()


def test_view_map_writes_its_png_and_the_smoothed_map(small_map, tmp_path, monkeypatch):
    from acmpc_tpu.cli import view_map as jax_view_map

    path, _ = small_map
    out, saved = tmp_path / "view.png", tmp_path / "smoothed.npy"
    built = view_map.main(["--map", str(path), "--out", str(out), "--smooth", "11",
                           "--save", str(saved), "--device", "cpu"])
    assert out.stat().st_size > 10_000
    again = np.load(saved, allow_pickle=True).item()
    # the JAX CLI on the same map writes the same smoothed map
    jax_saved = tmp_path / "jax_smoothed.npy"
    monkeypatch.setattr(sys, "argv", ["view_map", "--map", str(path), "--out", str(tmp_path / "jax.png"),
                                      "--smooth", "11", "--save", str(jax_saved)])
    jax_view_map.main()
    want = np.load(jax_saved, allow_pickle=True).item()
    for key in ("outside_track", "inside_track", "centre_track"):
        np.testing.assert_array_equal(again[key], built[key])
        assert built[key].shape == (300, 2)
        np.testing.assert_allclose(built[key], want[key], rtol=1e-5, atol=1e-4)


def _synthesised_recording(tmp_path, tm):
    """tests/test_tools.py::test_benchmark_localisation_replay's
    recording: the true car driven round the loop, 120 steps."""
    from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
    from acmpc_tpu_torch.localise.benchmarking import LocalisationRecorder
    from test_localise import observation_from_pose

    rec = LocalisationRecorder(str(tmp_path / "rec"))
    centre = np.asarray(tm.centre)
    m = len(centre)
    spacing = float(np.linalg.norm(centre[1] - centre[0]))
    v, dt = 20.0, 0.1
    step_pts = max(1, int(round(v * dt / spacing)))
    t = 0.0
    veh = VehicleParams()
    for k in range(120):
        i = (40 + k * step_pts) % m
        p0, p1 = centre[i], centre[(i + 1) % m]
        yaw = np.arctan2(p1[1] - p0[1], p1[0] - p0[0])
        pose = np.array([p0[0], p0[1], yaw], np.float32)
        left, right = observation_from_pose(tm, pose)
        rec.record_observation(t, left, right)
        i2 = (i + step_pts) % m
        p2, p3 = centre[i2], centre[(i2 + 1) % m]
        yaw2 = np.arctan2(p3[1] - p2[1], p3[0] - p2[0])
        dyaw = (yaw2 - yaw + np.pi) % (2 * np.pi) - np.pi
        delta = np.arctan(veh.wheelbase * (dyaw / dt) / v)
        rec.record_control(t + dt / 2, (-delta / veh.max_steering_angle, 0.0, v),
                           [-pose[0], 0.0, pose[1], pose[2]])
        t += dt
    rec.save()
    return tmp_path / "rec"


def _benchmark_yaml(tmp_path, data, map_path):
    """configs/benchmarks/monza.yaml pointed at the synthesised recording,
    with the JAX test's localisation settings."""
    text = open("configs/benchmarks/monza.yaml").read()
    for old, new in (
        ("data_path: data/localisation/monza_synth/racing", f"data_path: {data}"),
        ("map_path: data/maps/monza.npz", f"map_path: {map_path}"),
        ("n_particles: 500", "n_particles: 400"),
        ("n_converged_particles: 500", "n_converged_particles: 400"),
        ("track_limit: 25.0", "track_limit: 4.0"),
        ("sigma: 10", "sigma: 1"),
    ):
        assert old in text, old
        text = text.replace(old, new)
    path = tmp_path / "bench.yaml"
    path.write_text(text)
    return path


def test_benchmark_localisation_cli_replays_with_its_figure(tmp_path, capsys):
    from test_localise import make_asymmetric_map

    tm = make_asymmetric_map()
    map_path = tmp_path / "map.npz"
    save_track_map(map_path, np.asarray(tm.centre), np.asarray(tm.left), np.asarray(tm.right))
    data = _synthesised_recording(tmp_path, tm)
    figure = tmp_path / "benchmark.png"
    summary = benchmark_localisation.main([
        "--benchmark-config", str(_benchmark_yaml(tmp_path, data, map_path)),
        "--figure", str(figure), "--device", "cpu",
    ])
    # tests/test_tools.py's bounds
    assert summary["n_steps"] == 120 and summary["n_observations"] == 120
    assert summary["percent_localised"] >= 0.0
    assert np.isfinite(summary["step_p50_ms"])
    assert figure.exists() and figure.stat().st_size > 10_000
    out = capsys.readouterr().out
    assert "Percentage of time localised" in out and f"figure saved to {figure}" in out


def test_benchmark_replay_feeds_the_visualiser(tmp_path):
    # the replay's hooks, as tests/test_tools.py drives them
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.localise.benchmarking import BenchmarkLocalisation
    from acmpc_tpu_torch.localise.benchmarking.visualisation import LocalisationVisualiser
    from test_localise import make_asymmetric_map

    tm = make_asymmetric_map()
    map_path = tmp_path / "map.npz"
    save_track_map(map_path, np.asarray(tm.centre), np.asarray(tm.left), np.asarray(tm.right))
    data = _synthesised_recording(tmp_path, tm)
    cfg = dataclasses.replace(
        load_config("configs/monza.yaml").localisation,
        threshold_track_limit=4.0, score_sigma=1.0, n_particles=400, n_converged_particles=400,
    )
    bench = BenchmarkLocalisation(str(data), str(map_path), cfg, device="cpu")
    vis = LocalisationVisualiser(bench.localiser, bench.tracker)
    summary = bench.run(visualiser=vis, max_steps=60)
    assert summary["n_steps"] == 60
    assert len(vis._estimates) == 60 and len(vis._particle_snapshots) == 50
    assert vis._last_detections is not None and vis._last_scores is not None
    path = vis.save_figure(str(tmp_path / "fig.png"))
    assert (tmp_path / "fig.png").stat().st_size > 10_000 and path.endswith("fig.png")


@pytest.mark.parametrize(
    "cli, argv",
    [
        (raceline, ["--map", "data/maps/monza.npz", "--out", "x.npy"]),
        (view_map, ["--map", "data/maps/monza.npz"]),
        (benchmark_localisation, ["--benchmark-config", "configs/benchmarks/monza.yaml"]),
    ],
    ids=["raceline", "view_map", "benchmark_localisation"],
)
def test_clis_default_to_cuda(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
