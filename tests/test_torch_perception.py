"""Perception in the port against the JAX package: configuration, camera,
the connected-run chain, row edges, polyfit, the extractor, the
segmenter on the shipped checkpoint and the Perceiver.

Integer and boolean outputs (the chain, the connected-run masks, row
edge columns, validity masks, drivable masks) must be equal. The JAX
side runs under ``jax.default_matmul_precision("highest")`` (XLA's CPU
dots otherwise round fp32 through bf16). Tolerances:

* raw boundary points: fp32 homography in two libraries, 1e-5 relative;
* polylines: rtol 1e-4, atol 1e-3 m. The fit solves 3x3 normal
  equations whose y**4 entries reach ~5e8 at y = 150 m, an
  ill-conditioned system that LAPACK through XLA and through PyTorch
  round differently; the fitted points agreed to 7.4e-5 m on sim masks;
* segmentation: fp32 masks agree on >= 99.9% of pixels (logits agree
  to 1e-4, tests/test_torch_fpn.py, so only near-ties may flip);
* bf16 segmentation against the JAX package's bf16: masks agree on
  >= 99.9% of pixels; logits (fp32 from the fp32 head, up to ~28)
  within 0.25 absolute, two bf16 spacings at that size, since the two
  libraries round each bf16 layer's output after summing in different
  orders (measured 0.16), and within 0.0135 in the mean (measured 0.011;
  an fp32 FPN against the JAX package's bf16 gives 0.017, so the mean
  tells a bf16 FPN from one that skips a cast).
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.perception import tracks as jtracks
from acmpc_tpu.perception.camera import CameraInfo as JCamera
from acmpc_tpu.perception.observations import ObservationDict as JObservationDict
from acmpc_tpu.perception.perceiver import Perceiver as JPerceiver
from acmpc_tpu.perception.segmentation import TrackSegmenter as JSegmenter
from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.config import load_config
from acmpc_tpu_torch.convert import perceiver_from_numpy
from acmpc_tpu_torch.models.checkpoint import read_checkpoint
from acmpc_tpu_torch.ops import track_chain
from acmpc_tpu_torch.perception import tracks
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.observations import ObservationDict
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_track_extraction_adversarial as adversarial  # noqa: E402
from test_perception import PCFG as J_PCFG, synthetic_road_mask  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRACKS = ["monza", "spa", "silverstone", "nordschleife", "vallelunga", "bathurst", "yas_marina"]
RAW_TOL = dict(rtol=1e-5, atol=1e-5)
POLY_TOL = dict(rtol=1e-4, atol=1e-3)
MASK_AGREE = 0.999
BF16_LOGIT_TOL = 0.25
BF16_LOGIT_MEAN_TOL = 0.0135
ADVERSARIAL = {
    "straight": adversarial.straight_mask,
    "hairpin": adversarial.hairpin_mask,
    "noise_blob": adversarial.noise_blob_mask,
    "gap": adversarial.gap_mask,
    "long_gap": adversarial.long_gap_mask,
    "empty": lambda: np.zeros((adversarial.H, adversarial.W), np.uint8),
}
BONNET = adversarial.BONNET
N_SIM_POSES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(**changes):
    """(JAX, port) monza perception configs with the same changes."""
    j = dataclasses.replace(j_load_config(ROOT / "configs" / "monza.yaml").perception, **changes)
    t = dataclasses.replace(load_config(ROOT / "configs" / "monza.yaml").perception, **changes)
    return j, t


SMALL = dict(
    image_width=320, image_height=192, n_rows_to_remove_bonnet=160, n_polyfit_points=200,
    camera_position=(0.0, 0.0, 1.2), camera_pitch_deg=9.0, precision="fp32",
)


@pytest.fixture(scope="module")
def sim_masks():
    """Drivable masks the port's sim renders at 320x192 on bench.py's
    circuit, at poses spread round it and off its centreline."""
    _, cfg = _cfgs(**SMALL)
    centre, left, right, _ = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    masks = []
    for k in range(N_SIM_POSES):
        i = k * len(centre) // N_SIM_POSES
        p0, p1 = centre[i], centre[(i + 1) % len(centre)]
        heading = float(np.arctan2(p1[1] - p0[1], p1[0] - p0[0]))
        pos = p0 + 2.5 * np.sin(1.7 * k) * np.array([-np.sin(heading), np.cos(heading)])
        sim.x, sim.y, sim.yaw = float(pos[0]), float(pos[1]), heading + 0.3 * np.cos(2.3 * k)
        masks.append(sim.render_drivable_mask())
    return masks


def _random_mask(seed: int) -> np.ndarray:
    """A 64 x 96 mask of random vertical streaks and holes: runs that
    merge, split and break, at a seeded density."""
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.3, 0.9)
    m = (rng.random((64, 96)) < density).astype(np.uint8)
    # vertical coherence: OR with the row below at random
    for r in range(62, -1, -1):
        m[r] |= m[r + 1] & (rng.random(96) < 0.5)
    return m


# -- configuration and camera ----------------------------------------------


@pytest.mark.parametrize("track", TRACKS)
def test_perception_config_matches_jax(track):
    j = j_load_config(ROOT / "configs" / f"{track}.yaml").perception
    t = load_config(ROOT / "configs" / f"{track}.yaml").perception
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.camera_position == tuple(t.camera_position) and len(t.camera_position) == 3


@pytest.mark.parametrize("changes", [{}, SMALL])
def test_camera_matches_jax(changes):
    j, t = _cfgs(**changes)
    jc, tc = JCamera.from_config(j), CameraInfo.from_config(t)
    for name in ("camera_matrix", "rotation_matrix", "homography_w2i", "homography_i2w"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    pts = np.array([[10.0, 100.0], [160.0, 150.0], [300.0, 20.0]])
    np.testing.assert_array_equal(tc.image_to_ground(pts), jc.image_to_ground(pts))
    np.testing.assert_array_equal(tc.ground_to_image(pts), jc.ground_to_image(pts))


def test_camera_below_ground_raises():
    with pytest.raises(ValueError):
        CameraInfo(64, 32, 60.0, (0.0, 0.0, 0.0), 0.0)


# -- the connected-run chain and row edges ----------------------------------


def _check_chain(mask: np.ndarray, bonnet: int, band: int, gap: int = 3):
    """The port's connected runs, the scan's rows and the scan itself
    against the JAX package's, bit for bit."""
    with jax.default_matmul_precision("highest"):
        want = np.asarray(
            jtracks.select_vehicle_connected_runs(jnp.asarray(mask), bonnet, gap, band)
        )
    t = torch.from_numpy(mask)
    got = tracks.select_vehicle_connected_runs(t, bonnet, gap, band)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    _, rows, scan_gap = tracks.scan_rows(t, bonnet, gap, band)
    want_scan = np.asarray(jtracks._chain_scan(jnp.asarray(rows.numpy()), scan_gap))
    np.testing.assert_array_equal(track_chain.chain_scan(rows, scan_gap).numpy(), want_scan)
    return got.numpy()


@pytest.mark.parametrize("band", [1, 4])
@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_connected_runs_match_jax_on_adversarial_masks(name, band):
    _check_chain(ADVERSARIAL[name](), BONNET, band)


@pytest.mark.parametrize("band", [1, 2, 4])
@pytest.mark.parametrize("seed", range(8))
def test_connected_runs_match_jax_on_random_masks(seed, band):
    _check_chain(_random_mask(seed), 56 + seed % 8, band, gap=seed % 4)


@pytest.mark.parametrize("band", [1, 4])
def test_connected_runs_match_jax_on_sim_masks(sim_masks, band):
    for mask in sim_masks:
        _check_chain(mask, SMALL["n_rows_to_remove_bonnet"], band)


@pytest.mark.parametrize("band", [1, 4])
def test_connected_runs_take_a_strided_mask(band):
    # a mask with another memory layout (numpy's fancy indexing gives
    # one): the scan still gets contiguous rows
    mask = np.ascontiguousarray(adversarial.hairpin_mask().T).T
    assert not torch.from_numpy(mask).is_contiguous()
    _check_chain(mask, BONNET, band)


def test_connected_runs_keep_the_adversarial_semantics():
    """The adversarial suite's assertions, on the port."""
    sel = _check_chain(adversarial.hairpin_mask(), BONNET, 1)
    assert sel[40, 66:86].sum() == 0  # far leg below the apex dropped
    assert sel[15, 80] == 1  # the apex joins the legs
    sel = _check_chain(adversarial.noise_blob_mask(), BONNET, 1)
    assert sel[30:40, 4:14].sum() == 0
    sel = _check_chain(adversarial.long_gap_mask(), BONNET, 1)
    assert sel[:28].sum() == 0 and sel[36:BONNET].sum() > 0


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_row_edge_columns_match_jax(name, sim_masks):
    for mask in [ADVERSARIAL[name](), _random_mask(len(name)), sim_masks[len(name) % N_SIM_POSES]]:
        want = jtracks.row_edge_columns(jnp.asarray(mask))
        got = tracks.row_edge_columns(torch.from_numpy(mask))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_chain_scan_on_cpu_takes_the_plain_version():
    track_chain.chain_scan.launches.clear()
    rows = torch.from_numpy(_random_mask(3))
    np.testing.assert_array_equal(
        track_chain.chain_scan(rows, 1).numpy(),
        track_chain.chain_scan_reference(rows, 1).numpy(),
    )
    assert sum(track_chain.chain_scan.launches.values()) == 0


@pytest.mark.parametrize(
    "rows, error",
    [
        (torch.zeros(4, 8, dtype=torch.float32), TypeError),
        (torch.zeros(8, dtype=torch.bool), ValueError),
        (torch.zeros(2, 4, 8, dtype=torch.bool), ValueError),  # one frame only
        (torch.zeros(2, 2, 4, 8, dtype=torch.bool), ValueError),
        (torch.zeros(8, 4, dtype=torch.bool).T, ValueError),
        (torch.zeros(2, track_chain.MAX_WIDTH + 1, dtype=torch.bool), ValueError),
    ],
)
def test_chain_scan_refuses_bad_rows(rows, error):
    with pytest.raises(error):
        track_chain.chain_scan(rows, 1)


# -- polyfit and the extractor ----------------------------------------------


def _jax_polyfit(points, weights, n):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jtracks.masked_polyfit_track(jnp.asarray(points), jnp.asarray(weights), n))


@pytest.mark.parametrize("seed", range(4))
def test_polyfit_matches_jax(seed):
    rng = np.random.default_rng(seed)
    y = np.sort(rng.uniform(2.0, 140.0, 150)).astype(np.float32)
    x = (rng.normal(0, 0.002) * y**2 + rng.normal(0, 0.2) * y + rng.normal(0, 3) + rng.normal(0, 0.3, 150)).astype(np.float32)
    points = np.stack([x, y], axis=1)
    weights = rng.random(150) < 0.7
    got = tracks.masked_polyfit_track(torch.from_numpy(points), torch.from_numpy(weights), 100)
    np.testing.assert_allclose(got.numpy(), _jax_polyfit(points, weights, 100), **POLY_TOL)


def test_polyfit_recovers_parabola_and_stub():
    y = np.linspace(1.0, 50.0, 80, dtype=np.float32)
    pts = torch.from_numpy(np.stack([0.01 * y**2 - 0.2 * y + 1.0, y], axis=1))
    out = tracks.masked_polyfit_track(pts, torch.ones(80, dtype=torch.bool), 50).numpy()
    np.testing.assert_allclose(out[:, 0], 0.01 * out[:, 1] ** 2 - 0.2 * out[:, 1] + 1.0, atol=1e-3)
    stub = tracks.masked_polyfit_track(torch.zeros(10, 2), torch.zeros(10, dtype=torch.bool), 25).numpy()
    # linspace in two libraries: 1 ulp apart
    np.testing.assert_allclose(
        stub, _jax_polyfit(np.zeros((10, 2), np.float32), np.zeros(10, bool), 25), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(stub[-1], [0.1, 2.0], atol=1e-6)


def _extractors(changes, **cfg_changes):
    j, t = _cfgs(**changes)
    jcfg = jtracks.TrackExtractionConfig.from_config(j)
    tcfg = tracks.TrackExtractionConfig.from_config(t)
    jcfg = dataclasses.replace(jcfg, **cfg_changes)
    tcfg = dataclasses.replace(tcfg, **cfg_changes)
    jext = jax.jit(jtracks.TrackLimitExtractor(jcfg, JCamera.from_config(j)).extract)
    return jext, tracks.TrackLimitExtractor(tcfg, CameraInfo.from_config(t), device="cpu")


def _assert_tracks_match(want: dict, got: dict):
    assert set(got) == set(want)
    for key in ("left_raw_mask", "right_raw_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("left_raw", "right_raw"):
        valid = np.asarray(want[f"{key}_mask"])
        np.testing.assert_allclose(got[key].numpy()[valid], np.asarray(want[key])[valid], **RAW_TOL)
    for key in ("left", "right", "centre"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **POLY_TOL)


def test_extract_matches_jax_on_straight_road():
    fields = {f.name for f in dataclasses.fields(J_PCFG)}
    changes = {k: getattr(J_PCFG, k) for k in fields if k != "model_path"}
    jext, ext = _extractors(changes)
    mask = synthetic_road_mask(CameraInfo.from_config(_cfgs(**changes)[1]), J_PCFG)
    with jax.default_matmul_precision("highest"):
        want = jext(jnp.asarray(mask))
    got = ext.extract(torch.from_numpy(mask))
    _assert_tracks_match(want, got)
    left, right = got["left"].numpy(), got["right"].numpy()
    assert abs(np.median(left[:, 0]) + 5.0) < 1.0 and abs(np.median(right[:, 0]) - 5.0) < 1.0


@pytest.mark.parametrize("connected_runs", [True, False])
def test_extract_matches_jax_on_sim_masks(sim_masks, connected_runs):
    jext, ext = _extractors(SMALL, connected_runs=connected_runs)
    for mask in sim_masks + [np.zeros_like(sim_masks[0])]:
        with jax.default_matmul_precision("highest"):
            want = jext(jnp.asarray(mask))
        _assert_tracks_match(want, ext.extract(torch.from_numpy(mask)))


def test_maybe_interpolate_track_limit_matches_jax():
    rng = np.random.default_rng(0)
    long_ = np.cumsum(rng.normal(size=(20, 2)), axis=0)
    short = long_[:3]
    for left, right in ((short, long_), (long_, short), (long_, long_)):
        want = jtracks.maybe_interpolate_track_limit(left, right)
        got = tracks.maybe_interpolate_track_limit(left, right)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


# -- segmentation and the Perceiver on the shipped checkpoint ---------------


@pytest.fixture(scope="module")
def shipped_pair():
    """(JAX Perceiver, port Perceiver, frame, true mask) at 320x192 fp32
    on test_assets.py's 800-point track, training camera, start 123."""
    from acmpc_tpu_torch.localise.track_map import TrackMap
    from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

    j, t = _cfgs(**SMALL)
    theta = np.linspace(0, 2 * np.pi, 800, endpoint=False)
    r = 160.0 + 25.0 * np.sin(2 * theta)
    ring = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    d = np.roll(ring, -1, axis=0) - ring
    tan = d / np.linalg.norm(d, axis=1, keepdims=True)
    nrm = np.stack([-tan[:, 1], tan[:, 0]], axis=1)
    tm = TrackMap(*(torch.tensor(v, dtype=torch.float32) for v in (ring, ring + 5 * nrm, ring - 5 * nrm)))
    sim = SyntheticSimulator(tm, CameraInfo.from_config(t), half_width=5.0, start_index=123)
    truth = sim.render_drivable_mask()
    frame = sim.render_camera_image(truth)
    return JPerceiver(j), Perceiver(t, device="cpu"), frame, truth


def _iou(pred, truth):
    pred, truth = np.asarray(pred) == 1, truth.astype(bool)
    return (pred & truth).sum() / max((pred | truth).sum(), 1)


def test_segmentation_matches_jax_and_passes_iou_gate(shipped_pair):
    jperc, perc, frame, truth = shipped_pair
    with jax.default_matmul_precision("highest"):
        want, _ = jperc.segmenter.segment_drivable_area(frame)
    got, semantics = perc.segmenter.segment_drivable_area(frame)
    assert (got.numpy() == np.asarray(want)).mean() >= MASK_AGREE
    assert semantics.dtype == torch.uint8 and int(semantics.max()) < 10
    assert _iou(got.numpy(), truth) > 0.85


def test_bf16_segmentation_passes_iou_gate(shipped_pair):
    _, _, frame, truth = shipped_pair
    _, t = _cfgs(**{**SMALL, "precision": "bf16"})
    seg = TrackSegmenter(t, device="cpu")
    drivable, _ = seg.segment_drivable_area(frame)
    assert _iou(drivable.numpy(), truth) > 0.85


def test_bf16_segmentation_matches_jax_bf16(shipped_pair):
    """bf16 on both sides, parameters cast from the stored fp16 and the
    frame cast then divided by 255 in bf16 (segmentation.py:73-80,100)."""
    _, _, frame, _ = shipped_pair
    j, t = _cfgs(**{**SMALL, "precision": "bf16"})
    jseg, seg = JSegmenter(j), TrackSegmenter(t, device="cpu")

    def jax_forward(variables, image):
        x = image.astype(jnp.bfloat16) / 255.0
        return jseg._apply(variables, image)[0], jseg.model.apply(variables, x[None])

    with jax.default_matmul_precision("highest"):
        want_mask, want = jax.jit(jax_forward)(jseg.variables, jnp.asarray(frame))
    want = np.asarray(want)
    x = torch.from_numpy(frame).to(torch.bfloat16) / 255.0
    with torch.no_grad():
        got = seg.model(x[None])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    got = got.numpy()
    err = np.abs(got - want)
    assert err.max() <= BF16_LOGIT_TOL and err.mean() <= BF16_LOGIT_MEAN_TOL
    # argmax flips only where the top two logits are within the tolerance
    top2 = np.sort(want, axis=-1)[..., -2:]
    flipped = got.argmax(-1) != want.argmax(-1)
    assert not (flipped & (top2[..., 1] - top2[..., 0] >= 2 * BF16_LOGIT_TOL)).any()
    drivable, _ = seg.segment_drivable_area(frame)
    assert (drivable.numpy() == np.asarray(want_mask)).mean() >= MASK_AGREE


def test_run_pipeline_matches_jax(shipped_pair):
    jperc, perc, frame, _ = shipped_pair
    with jax.default_matmul_precision("highest"):
        jd, _, jt = jperc._pipeline(jperc.segmenter.variables, jnp.asarray(frame))
    d, _, t = perc._run_pipeline(torch.from_numpy(frame))
    assert (d.numpy() == np.asarray(jd)).mean() >= MASK_AGREE
    if np.array_equal(d.numpy(), np.asarray(jd)):
        _assert_tracks_match(jt, t)
    else:  # a flipped near-tie pixel may move one boundary point
        for key in ("left", "right", "centre"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(jt[key]), rtol=1e-3, atol=0.05)


def test_perceive_matches_jax(shipped_pair):
    jperc, perc, frame, _ = shipped_pair
    # another size than the config's: the resize guard runs too
    big = np.repeat(np.repeat(frame, 2, axis=0), 2, axis=1)
    with jax.default_matmul_precision("highest"):
        want = jperc.perceive(big)
    got = perc.perceive(big)
    assert set(got) == set(want)
    assert (got["drivable"].numpy() == np.asarray(want["drivable"])).mean() >= MASK_AGREE
    np.testing.assert_allclose(got["centreline"].numpy(), np.asarray(want["centreline"]), rtol=1e-3, atol=0.05)


def test_perceiver_from_numpy_carries_jax_weights(shipped_pair):
    jperc, perc, frame, _ = shipped_pair
    variables = jax.tree_util.tree_map(np.asarray, jperc.segmenter.variables)
    other = perceiver_from_numpy(perc.cfg, variables, device="cpu")
    a, _, _ = other._run_pipeline(torch.from_numpy(frame))
    b, _, _ = perc._run_pipeline(torch.from_numpy(frame))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_segmenter_raises_where_jax_falls_back(tmp_path):
    j, t = _cfgs(**{**SMALL, "model_path": str(tmp_path / "absent.msgpack")})
    with pytest.raises(FileNotFoundError):
        TrackSegmenter(t, device="cpu")
    with pytest.raises(FileNotFoundError):
        Perceiver(t, device="cpu")
    # the JAX package warns and initialises random weights instead
    with pytest.warns(UserWarning, match="RANDOM"):
        JSegmenter(j)


def test_segmenter_takes_numpy_variables(shipped_pair):
    _, perc, frame, _ = shipped_pair
    variables = read_checkpoint(ROOT / perc.cfg.model_path)
    seg = TrackSegmenter(perc.cfg, variables, device="cpu")
    a, _ = seg.segment_drivable_area(frame)
    b, _ = perc.segmenter.segment_drivable_area(frame)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_observation_dict_matches_jax(shipped_pair):
    _, perc, frame, _ = shipped_pair
    centre, left, right, _ = loop.circuit()
    sim = loop.make_sim(perc.cfg, centre, left, right)
    obs = sim.step(np.array([0.1, 0.0, 0.5]))
    want, got = JObservationDict(obs), ObservationDict(obs)
    assert set(want) == set(got)
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key
    assert got.get_images()[0] is obs["image"]
