"""The dashboard: the port's session tracker, panels, JPEG encoder and live
server against the JAX package's (which draws and encodes with OpenCV,
present in this environment).

The port draws with numpy (``dashboard/raster.py``): filled circles and
crosses follow OpenCV's pixel rules exactly, the triangle's sides and the
label glyphs do not, and the bilinear resize rounds in floating point
where OpenCV uses fixed point. So panels are compared by their lit
pixels, each within one pixel of a lit pixel of the other, with the
label box left out; the palette and the shapes must be exact.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from acmpc_tpu_torch.dashboard import jpeg, raster, render
from acmpc_tpu_torch.dashboard.session import SessionTracker, format_delta, format_time

# OpenCV's quality-80 file against the port's: the decoded image's PSNR
# may be at most 1 dB lower, the file at most 25% larger or smaller
PSNR_SLACK_DB = 1.0
SIZE_RATIO = 0.25
LABEL_ROWS = 36  # the label box's rows at the top of each composite tile
LIT = 32  # a pixel is lit when a channel exceeds this


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lit(img: np.ndarray, level: int = LIT) -> np.ndarray:
    return (img.max(axis=-1) if img.ndim == 3 else img) > level


def assert_lit_within_one_pixel(got: np.ndarray, want: np.ndarray):
    """Every lit pixel of each image lies within one pixel (8-neighbour)
    of a lit pixel of the other; the other's pixel may be one rounding
    step (2 levels) below the threshold, since the resizes round apart."""
    assert got.shape == want.shape and got.dtype == want.dtype
    a, b = _lit(got), _lit(want)
    kernel = np.ones((3, 3), np.uint8)
    near_b = cv2.dilate(_lit(want, LIT - 2).astype(np.uint8), kernel).astype(bool)
    near_a = cv2.dilate(_lit(got, LIT - 2).astype(np.uint8), kernel).astype(bool)
    assert not (a & ~near_b).any(), f"{int((a & ~near_b).sum())} lit pixels of the port's far from JAX's"
    assert not (b & ~near_a).any(), f"{int((b & ~near_a).sum())} lit pixels of JAX's far from the port's"


def _colours(img: np.ndarray) -> set:
    return {tuple(c) for c in img.reshape(-1, 3)[_lit(img).ravel()]}


# -- session ---------------------------------------------------------------

def _random_updates(rng, n_laps=4):
    """A stream of observation states: laptimes rising through three
    sectors, laps completing with an official time."""
    out = []
    for lap in range(n_laps):
        t = 0.0
        for sector in range(3):
            for _ in range(rng.integers(1, 5)):
                t += float(rng.uniform(500, 6000))
                out.append({"i_current_time": t, "current_sector_index": sector, "completed_laps": lap})
        out.append({
            "i_current_time": float(rng.uniform(0, 200)),
            "current_sector_index": 0,
            "completed_laps": lap + 1,
            "i_last_time": t + float(rng.uniform(-300, 300)),
        })
    return out


@pytest.mark.parametrize("seed", range(5))
def test_session_tracker_matches_jax_exactly(seed):
    from acmpc_tpu.dashboard.session import SessionTracker as JTracker

    ours, ref = SessionTracker(), JTracker()
    for state in _random_updates(np.random.default_rng(seed)):
        ours.update(dict(state))
        ref.update(dict(state))
        assert ours.snapshot() == ref.snapshot()


def test_format_time_and_delta_match_jax():
    from acmpc_tpu.dashboard import session as js

    for v in [None, -5.0, 0, 0.4, 1, 999.9, 61500, 3_599_999, 12_345_678.9]:
        assert format_time(v) == js.format_time(v)
        assert format_delta(v) == js.format_delta(v)


def test_session_tracker_sectors():
    # tests/test_dashboard.py::test_session_tracker_sectors on the port
    st = SessionTracker()
    for t, sector in [(4000, 0), (10000, 0), (15000, 1), (22000, 1), (25000, 2), (30000, 2)]:
        st.update({"i_current_time": t, "current_sector_index": sector, "completed_laps": 0})
    st.update({"i_current_time": 100, "current_sector_index": 0, "completed_laps": 1, "i_last_time": 30000})
    snap = st.snapshot()
    assert snap["last"]["time"] == "00:30.000" and snap["last"]["colour"] == "purple"
    assert [s["time"] for s in snap["last"]["sectors"]] == ["00:10.000", "00:12.000", "00:08.000"]
    for t, sector in [(11000, 0), (15000, 1), (21000, 1), (26000, 2), (32000, 2)]:
        st.update({"i_current_time": t, "current_sector_index": sector, "completed_laps": 1})
    st.update({"i_current_time": 50, "current_sector_index": 0, "completed_laps": 2, "i_last_time": 32000})
    snap = st.snapshot()
    assert snap["last"]["colour"] == "yellow" and snap["last"]["delta"] == "+00:02.000"
    assert snap["best_sectors"] == ["00:10.000", "00:10.000", "00:08.000"]


# -- primitives --------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 4])
def test_filled_circles_are_opencvs(radius):
    rng = np.random.default_rng(radius)
    centres = rng.integers(-5, 45, (30, 2))
    want = np.zeros((40, 40, 3), np.uint8)
    for x, y in centres:
        cv2.circle(want, (int(x), int(y)), radius, (0, 200, 200), -1)
    got = np.zeros_like(want)
    raster.fill_circles(got, centres, radius, (0, 200, 200))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "marker, size, thickness",
    [(raster.MARKER_CROSS, 12, 2), (raster.MARKER_CROSS, 14, 2), (raster.MARKER_TRIANGLE_UP, 10, 1)],
)
def test_markers_match_opencv(marker, size, thickness):
    cv_marker = {raster.MARKER_CROSS: cv2.MARKER_CROSS, raster.MARKER_TRIANGLE_UP: cv2.MARKER_TRIANGLE_UP}
    want = np.zeros((30, 30, 3), np.uint8)
    cv2.drawMarker(want, (15, 15), (0, 0, 255), cv_marker[marker], size, thickness)
    got = np.zeros_like(want)
    raster.draw_marker(got, (15, 15), (0, 0, 255), marker, size, thickness)
    if marker == raster.MARKER_CROSS:
        np.testing.assert_array_equal(got, want)
    assert_lit_within_one_pixel(got, want)


@pytest.mark.parametrize("src, dst", [((736, 1280), (626, 360)), ((400, 400), (360, 360)), ((64, 64), (360, 360))])
def test_resize_matches_opencv_inter_linear(src, dst):
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 256, (*src, 3), dtype=np.uint8), (5, 5), 1.5)
    got = raster.resize_linear(img, *dst)
    want = cv2.resize(img, dst)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_label_draws_every_feed_name_and_refuses_unknown_glyphs():
    img = np.zeros((40, 200, 3), np.uint8)
    for name in ("camera", "segmentation", "control", "semantics", "localisation", "map"):
        img[:] = 0
        raster.draw_label(img, name, (8, 24), (255, 255, 255))
        ys, xs = np.nonzero(img[..., 0])
        # on the baseline at y = 24 (descenders below), from x = 8
        assert ys.min() >= 10 and ys.max() <= 25 and xs.min() >= 8
    with pytest.raises(ValueError, match="no glyph"):
        raster.draw_label(img, "é", (8, 24), (255, 255, 255))


# -- panels ------------------------------------------------------------------

def test_palette_and_semantics_are_exact():
    from acmpc_tpu.dashboard import render as jr

    np.testing.assert_array_equal(render.SEMANTIC_PALETTE, jr.SEMANTIC_PALETTE)
    sem = np.random.default_rng(0).integers(-2, 12, (64, 96))
    np.testing.assert_array_equal(render.render_semantics(sem), jr.render_semantics(sem))


def _map_polys():
    from test_localise import make_asymmetric_map

    tm = make_asymmetric_map(300)
    return {k: np.asarray(getattr(tm, k)) for k in ("centre", "left", "right")}


@pytest.mark.parametrize("seed", range(3))
def test_panels_match_jax(seed):
    from acmpc_tpu.dashboard import render as jr

    rng = np.random.default_rng(seed)
    tracks = {k: rng.uniform(-60, 60, (50, 2)) for k in ("left", "right", "centre")}
    tracks["left"][3] = np.nan  # non-finite points are dropped
    prediction = rng.uniform(-60, 60, (20, 2))
    polys = _map_polys()
    particles = np.concatenate([rng.uniform(-250, 250, (300, 2)), rng.uniform(-3, 3, (300, 1))], 1)
    estimate = np.array([polys["centre"][10, 0], polys["centre"][10, 1], 0.3])
    car = estimate + np.array([8.0, -5.0, 0.0])
    cases = [
        ("bev", lambda m: m.render_bev(tracks, prediction)),
        ("bev_empty", lambda m: m.render_bev(None, None)),
        ("world", lambda m: m.render_world_map(polys, particles, estimate, car)),
        ("world_none", lambda m: m.render_world_map(None, None, None, None)),
        ("local", lambda m: m.render_local_localisation(polys, particles, estimate, car)),
        ("local_car", lambda m: m.render_local_localisation(polys, particles, None, car)),
        ("local_cloud", lambda m: m.render_local_localisation(polys, particles, None, None)),
    ]
    for name, draw in cases:
        got, want = draw(render), draw(jr)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert _colours(got) == _colours(want), name
        assert_lit_within_one_pixel(got, want)


def test_composite_matches_jax():
    from acmpc_tpu.dashboard import render as jr

    rng = np.random.default_rng(3)
    polys = _map_polys()
    camera = cv2.GaussianBlur(rng.integers(0, 256, (736, 1280, 3), dtype=np.uint8), (9, 9), 3)
    panels = {
        "camera": camera,
        "segmentation": (rng.random((192, 320)) > 0.5).astype(np.uint8) * 255,
        "semantics": render.render_semantics(rng.integers(0, 10, (64, 64))),
        "control": render.render_bev({"centre": rng.uniform(-50, 50, (40, 2))}, None),
        "map": render.render_world_map(polys, None, None, None),
        "localisation": np.zeros((400, 400, 3), np.float32),
    }
    got, want = render.compose_dashboard(panels), jr.compose_dashboard(panels)
    assert got.shape == want.shape and got.shape[1] == 1280 and got.dtype == np.uint8
    keep = (np.arange(got.shape[0]) % render.PANEL_HEIGHT) >= LABEL_ROWS
    assert_lit_within_one_pixel(got[keep], want[keep])
    assert np.abs(got[keep].astype(int) - want[keep]).mean() < 0.5
    # every tile carries its label in white
    assert (got[~keep] == 255).all(axis=-1).any()
    assert render.compose_dashboard({}).shape == jr.compose_dashboard({}).shape == (360, 1280, 3)


def test_dashboard_render_composites():
    # tests/test_tools.py::test_dashboard_render_composites on the port
    tracks = {k: np.random.uniform(-10, 10, (50, 2)) for k in ("left", "right", "centre")}
    bev = render.render_bev(tracks, np.random.uniform(-10, 10, (20, 2)))
    assert bev.shape == (400, 400, 3)
    world = render.render_world_map(
        _map_polys(), np.random.uniform(-100, 100, (100, 3)),
        np.array([0.0, 0.0, 0.0]), np.array([10.0, 10.0, 0.0]),
    )
    assert world.shape == (400, 400, 3)
    sem = render.render_semantics(np.random.randint(0, 10, (64, 64)))
    assert sem.shape == (64, 64, 3)
    frame = render.compose_dashboard({"bev": bev, "map": world, "sem": sem})
    assert frame.shape[1] == 1280 and frame.ndim == 3


# -- JPEG --------------------------------------------------------------------

def _psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _frames():
    rng = np.random.default_rng(0)
    polys = _map_polys()
    camera = cv2.GaussianBlur(rng.integers(0, 256, (736, 1280, 3), dtype=np.uint8), (9, 9), 3)
    composite = render.compose_dashboard({
        "camera": camera,
        "map": render.render_world_map(polys, rng.uniform(-200, 200, (300, 3)), None, None),
        "control": render.render_bev({"centre": rng.uniform(-50, 50, (40, 2))}, rng.uniform(-50, 50, (20, 2))),
    })
    return {
        "composite_1280": composite,
        "camera_1280x720": camera[:720],
        "odd_37x53": cv2.GaussianBlur(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8), (5, 5), 1),
        "flat": np.full((48, 80, 3), (30, 140, 220), np.uint8),
    }


@pytest.mark.parametrize("name", ["composite_1280", "camera_1280x720", "odd_37x53", "flat"])
def test_jpeg_decodes_and_matches_opencv_quality_80(name):
    img = _frames()[name]
    data = jpeg.encode_jpeg(img, 80)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    decoded = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert decoded is not None and decoded.shape == img.shape
    ok, ref = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), 80])
    assert ok
    ref_decoded = cv2.imdecode(ref, cv2.IMREAD_COLOR)
    assert _psnr(img, decoded) >= _psnr(img, ref_decoded) - PSNR_SLACK_DB
    assert abs(len(data) - len(ref)) <= SIZE_RATIO * len(ref)


def test_jpeg_tables_are_libjpegs_at_quality_80():
    luma, chroma = jpeg.quant_tables(80)
    # libjpeg: scale 200 - 2q = 40 percent, (base * 40 + 50) // 100
    assert luma[0] == 6 and luma[1] == 4 and luma.max() == 48
    assert chroma[0] == 7 and chroma.max() == 40
    assert sorted(jpeg.ZIGZAG) == list(range(64)) and list(jpeg.ZIGZAG[:6]) == [0, 1, 8, 16, 9, 2]
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((8, 8), np.uint8))


# -- the server --------------------------------------------------------------

class _FakeController:
    predicted_locations = np.stack([np.zeros(20), np.linspace(0, 40, 20)], 1)


@pytest.fixture(scope="module")
def cpu_localiser():
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.localise.localiser import Localiser
    from acmpc_tpu_torch.localise.track_map import TrackMap

    polys = _map_polys()
    tm = TrackMap(**{k: torch.tensor(v) for k, v in polys.items()})
    cfg = load_config("configs/monza.yaml").localisation
    return Localiser(cfg, tm, seed=0, device="cpu")


def test_render_panels_copies_tensors_to_the_host(cpu_localiser):
    from acmpc_tpu_torch.dashboard.server import FEED_NAMES, Dashboard

    dash = Dashboard(_fake_agent(cpu_localiser), None, port=0)
    dash._attach("composite", +1)
    panels = dash._render_panels()
    assert set(panels) == set(FEED_NAMES)
    for name, p in panels.items():
        assert isinstance(p, np.ndarray) and p.dtype == np.uint8, name
    assert panels["camera"].shape == (192, 320, 3)
    assert panels["semantics"].shape == (192, 320, 3)
    assert set(np.unique(panels["segmentation"])) <= {0, 255}
    # the particles (teal) and the estimate's cross (red) are drawn
    assert ((panels["map"] == (0, 200, 200)).all(-1)).any()
    assert ((panels["localisation"] == (0, 0, 255)).all(-1)).any()
    dash.render_once()
    assert dash.render_errors == 0 and len(dash.encode_ms) == 1
    for name in (*FEED_NAMES, "composite"):
        frame = dash._frame(name)
        assert frame[:2] == b"\xff\xd8" and frame[-2:] == b"\xff\xd9", name


def _fake_agent(localiser):
    agent = type("FakeAgent", (), {})()
    agent._latest_frames = {
        "camera": torch.randint(0, 256, (192, 320, 3), dtype=torch.uint8),
        "segmentation": torch.rand(192, 320) > 0.5,
        "semantics": torch.randint(0, 10, (192, 320)),
    }
    agent._latest_tracks = {"centre": np.stack([np.zeros(10), np.arange(10.0)], 1)}
    agent._latest_state = {"i_current_time": 1000, "completed_laps": 0}
    agent.controller = _FakeController()
    agent.localiser = localiser
    return agent


def test_watchers_receive_whole_jpegs_from_every_stream(cpu_localiser):
    # the client side of chip_smoke.py's phase 13 (bench/agent_loop.py)
    import time

    from acmpc_tpu_torch.bench import agent_loop
    from acmpc_tpu_torch.dashboard.server import FEED_NAMES, Dashboard

    dash = Dashboard(_fake_agent(cpu_localiser), None, port=0, fps=20.0)
    dash.start()
    watchers = agent_loop._watch_dashboard(dash)
    deadline = time.monotonic() + 60
    while min(w.frames for w in watchers.values()) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    report = agent_loop._dashboard_report(dash, watchers)
    assert set(report["feeds"]) == {"composite", *FEED_NAMES}
    assert agent_loop._dashboard_fails(report) == [], report
    assert all(f["frames"] >= 2 and f["ended"] for f in report["feeds"].values())
    assert report["composites_encoded"] >= 1 and report["composite_encode_ms_p50"] > 0


def test_render_loop_counts_errors_and_survives():
    from acmpc_tpu_torch.dashboard.server import Dashboard

    class Broken:
        _latest_frames = {"camera": "not an image"}

    dash = Dashboard(Broken(), None, port=0, fps=50.0)
    dash._attach("camera", +1)
    dash.start()
    try:
        import time

        deadline = time.monotonic() + 10
        while dash.render_errors < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert dash.render_errors >= 2 and dash._render_thread.is_alive()
        assert "Error" in dash.last_render_error
    finally:
        dash.stop()
    assert not dash._render_thread.is_alive()


@pytest.fixture(scope="module")
def live_dashboard(tmp_path_factory):
    """A dashboard serving the port's agent on the synthetic sim, on the
    CPU, with tests/test_dashboard.py's configuration."""
    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.dashboard.server import Dashboard
    from acmpc_tpu_torch.localise.track_map import load_track_map, save_track_map
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.runtime import Agent, SyntheticSimulator

    cfg = load_config("configs/monza.yaml")
    cfg = dataclasses.replace(
        cfg,
        perception=dataclasses.replace(
            cfg.perception, image_width=320, image_height=192,
            n_rows_to_remove_bonnet=160, n_polyfit_points=200,
        ),
        racing_control=dataclasses.replace(cfg.racing_control, horizon=20),
        localisation=dataclasses.replace(cfg.localisation, use_localisation=False),
        create_map=False,
    )
    from test_localise import make_asymmetric_map

    map_path = str(tmp_path_factory.mktemp("dash") / "track.npz")
    tm = make_asymmetric_map()
    save_track_map(map_path, np.asarray(tm.centre), np.asarray(tm.left), np.asarray(tm.right))
    sim = SyntheticSimulator(
        load_track_map(map_path, device="cpu"), CameraInfo.from_config(cfg.perception), half_width=5.0
    )
    agent = Agent(cfg, sim, use_oracle_perception=True, map_path=map_path, device="cpu")
    dash = Dashboard(agent, sim, port=0, fps=20.0)
    dash.start()
    try:
        # the port's first command comes from the first perceived frame
        obs = sim.step(agent.behaviour(sim.reset()))
        assert agent.controller.wait_for_first_command(timeout=180)
        for _ in range(10):
            obs = sim.step(agent.behaviour(obs))
        yield dash
    finally:
        dash.stop()
        agent.teardown()


def _get(dash, path: str, n_bytes: int | None = None):
    with urllib.request.urlopen(f"http://127.0.0.1:{dash.port}{path}", timeout=20) as r:
        return r.read(n_bytes) if n_bytes else r.read()


def test_dashboard_serves_grid_page_and_session(live_dashboard):
    page = _get(live_dashboard, "/").decode()
    for feed in ("camera", "segmentation", "control", "semantics", "localisation", "map"):
        assert feed in page
    assert "session" in page.lower()
    snap = json.loads(_get(live_dashboard, "/session.json"))
    assert "current" in snap and len(snap["best_sectors"]) == 3


@pytest.mark.parametrize("feed", ["control", "map", "segmentation"])
def test_dashboard_streams_per_feed_mjpeg(live_dashboard, feed):
    head = _get(live_dashboard, f"/feed/{feed}.mjpg", 512)
    assert b"--frame" in head and b"image/jpeg" in head
    assert b"\r\n\r\n\xff\xd8" in head  # the part's body is a JPEG
    assert live_dashboard.render_errors == 0, live_dashboard.last_render_error


def test_dashboard_composite_decodes(live_dashboard):
    with urllib.request.urlopen(f"http://127.0.0.1:{live_dashboard.port}/feed.mjpg", timeout=20) as r:
        buf = b""
        while buf.count(b"\xff\xd9") < 1 or b"\xff\xd8" not in buf:
            buf += r.read(4096)
    start = buf.index(b"\xff\xd8")
    frame = buf[start : buf.index(b"\xff\xd9", start) + 2]
    img = cv2.imdecode(np.frombuffer(frame, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape[1] == 1280
    assert live_dashboard.render_errors == 0, live_dashboard.last_render_error


def test_dashboard_streaming_layout_page(live_dashboard):
    page = _get(live_dashboard, "/stream").decode()
    assert "composite" in page and "session" in page.lower()


def test_dashboard_404_on_unknown_feed(live_dashboard):
    for path in ("/feed/nonsense.mjpg", "/feed/nonsense/stop", "/nothing"):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(live_dashboard, path, 10)
        assert err.value.code == 404


def test_feed_lifecycle_stops_server_side_rendering(live_dashboard):
    import time

    live_dashboard._attach("control", +1)
    assert live_dashboard._feed_active("control")
    with urllib.request.urlopen(f"http://127.0.0.1:{live_dashboard.port}/feed/control/stop", timeout=20) as r:
        assert r.status == 204
    assert not live_dashboard._feed_active("control")
    time.sleep(0.3)
    before = live_dashboard._frame("control")
    time.sleep(0.3)
    assert live_dashboard._frame("control") == before
    with urllib.request.urlopen(f"http://127.0.0.1:{live_dashboard.port}/feed/control/start", timeout=20) as r:
        assert r.status == 204
    assert live_dashboard._feed_active("control")
    live_dashboard._attach("control", -1)
    assert not live_dashboard._feed_active("control")
    assert live_dashboard.render_errors == 0, live_dashboard.last_render_error
