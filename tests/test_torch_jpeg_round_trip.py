"""The camera frame's JPEG round trip (``ops/jpeg_round_trip.py``): its
plain version against OpenCV's encode and decode at their defaults, byte
for byte, and the perceiver's choice of path.

The sizes cover each edge rule: whole MCUs; H even and not a multiple of
16 (the averaged chroma's last row repeated, not the luma's); H and W
odd; W at most 4 (chroma 2 samples wide: plain 2x2 upsampling); frames
down to 8x8. The on-card side (the kernels against this version and
OpenCV) is in ``test_torch_cuda.py``."""

import json
import pathlib

import cv2
import numpy as np
import pytest
import torch

from acmpc_tpu_torch.ops import jpeg_round_trip as jrt

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def opencv_round_trip(frame: np.ndarray) -> np.ndarray:
    ok, buf = cv2.imencode(".jpg", frame)
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


def _frame(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "blurred":
        frame = cv2.GaussianBlur(frame, (7, 7), 2.0)
    elif kind == "extremes":  # saturated colours: the range limits and clamps
        frame = np.where(frame > 127, 255, 0).astype(np.uint8)
    return np.ascontiguousarray(frame)


SIZES = [
    (16, 16), (32, 64), (48, 80),  # whole MCUs
    (10, 24), (22, 40), (40, 96), (8, 8),  # H even, not a multiple of 16
    (9, 17), (33, 31), (15, 131), (59, 33),  # H and W odd
    (8, 3), (13, 4), (11, 1), (1, 30),  # chroma at most 2 samples wide; one row
    (24, 150), (17, 30),
]


@pytest.mark.parametrize("kind", ["random", "blurred", "extremes"])
@pytest.mark.parametrize("h,w", SIZES)
def test_reference_equals_opencv(h, w, kind):
    frame = _frame(kind, h, w, 1000 * h + w)
    got = jrt.jpeg_round_trip_reference(torch.from_numpy(frame))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), opencv_round_trip(frame))


def test_reference_equals_opencv_on_every_small_size():
    # H 8-40 by W 8-40: each residue of the edge rules, blurred content
    mismatched = []
    for h in range(8, 41):
        for w in range(8, 41, 3):
            frame = _frame("blurred", h, w, h * 97 + w)
            got = jrt.jpeg_round_trip_reference(torch.from_numpy(frame)).numpy()
            if not np.array_equal(got, opencv_round_trip(frame)):
                mismatched.append((h, w))
    assert mismatched == []


@pytest.mark.parametrize("size", [(192, 320), (736, 1280)])
def test_reference_equals_opencv_on_simulator_frames(size):
    from acmpc_tpu_torch.bench import perception_loop as loop

    cfg = loop.perception_config(size[1], size[0])
    centre, left, right, _ = loop.circuit()
    frame = loop.make_sim(cfg, centre, left, right).reset()["image"]
    assert frame.shape == (*size, 3) and frame.dtype == np.uint8
    got = jrt.jpeg_round_trip_reference(torch.from_numpy(frame))
    np.testing.assert_array_equal(got.numpy(), opencv_round_trip(frame))


def _benchmark_frame(seed: int) -> np.ndarray:
    """One 1280x736 frame of the camera cell's renderer on the CPU."""
    from perfbench import frames
    from perfbench.reference.sweep import load_centre

    config = json.loads((ROOT / "perfbench/configs/monza_racing_h50.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/camera_b1.json").read_text())
    centre = load_centre(str(ROOT / traffic["map"]))
    rng = np.random.default_rng(seed)
    rows = frames.poses(centre, rng, 1, 1, traffic["frame_step_m"], traffic["offset_amp_m"],
                        traffic["yaw_jitter_deg"])
    gen = torch.Generator().manual_seed(seed)
    return frames.render(centre, config["agent"]["perception"], rows, traffic["half_width_m"], gen,
                         torch.device("cpu"))[0]


def test_reference_equals_opencv_on_a_benchmark_frame():
    frame = _benchmark_frame(2**31 + 11)
    assert frame.shape == (736, 1280, 3)
    got = jrt.jpeg_round_trip_reference(torch.from_numpy(frame))
    np.testing.assert_array_equal(got.numpy(), opencv_round_trip(frame))


@pytest.mark.parametrize("kind", ["random", "extremes"])
def test_int32_arithmetic_equals_int64(kind):
    # the kernels compute in int32; libjpeg in 32-bit INT32 as well
    frame = torch.from_numpy(_frame(kind, 736, 1280, 5))
    got = jrt.jpeg_round_trip_reference(frame, torch.int32)
    assert torch.equal(got, jrt.jpeg_round_trip_reference(frame, torch.int64))


def test_wrapper_takes_the_reference_on_the_cpu_and_refuses_bad_frames():
    frame = torch.from_numpy(_frame("random", 24, 40, 3))
    jrt.jpeg_round_trip.launches.clear()
    assert torch.equal(jrt.jpeg_round_trip(frame), jrt.jpeg_round_trip_reference(frame))
    assert sum(jrt.jpeg_round_trip.launches.values()) == 0
    with pytest.raises(ValueError):  # the kernels' entry takes CUDA tensors only
        jrt._launch(frame)
    with pytest.raises(TypeError):
        jrt.jpeg_round_trip(frame.float())
    for bad in (frame[..., :2], frame[0], frame[:0]):
        with pytest.raises(ValueError):
            jrt.jpeg_round_trip(bad)


def test_quantisation_tables_are_libjpegs_at_quality_95():
    q = jrt.quantisation()
    assert q.shape == (2, 64) and q.dtype == np.int32
    # jpeg_set_quality(95): the IJG tables scaled by 10%, rounded, at least 1
    assert q[0, :8].tolist() == [2, 1, 1, 2, 2, 4, 5, 6]
    assert q[1, :8].tolist() == [2, 2, 2, 5, 10, 10, 10, 10]
    assert list(jrt.padded_shape(736, 1280)) == [736, 1280]
    assert list(jrt.padded_shape(17, 9)) == [32, 16]


# -- the perceiver's choice of path --------------------------------------------


@pytest.fixture(scope="module")
def small_perceiver():
    from acmpc_tpu_torch.bench.perception_loop import perception_config
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    return Perceiver(perception_config(160, 96, "fp32"), device="cpu")


def test_the_card_path_engages_by_device_and_frame_only(small_perceiver, monkeypatch):
    perc = small_perceiver
    frame = _frame("random", 96, 160, 0)
    # a CPU perceiver never takes it
    assert not perc._round_trip_on_card(frame)
    monkeypatch.setattr(perc, "device", torch.device("cuda"))
    # the frame's memory layout plays no part: a view takes the card path too
    for view in (frame, np.asfortranarray(frame), frame[::-1], frame[:, :, ::-1]):
        assert perc._round_trip_on_card(view)
    for other in (
        _frame("random", 96, 162, 0),  # another size: round trip, then resize, on the host
        frame.astype(np.float32),
        frame[..., :1].copy(),
        torch.from_numpy(frame),
    ):
        assert not perc._round_trip_on_card(other)


def test_cpu_perceive_counts_the_host_path(small_perceiver):
    from acmpc_tpu_torch.utils.monitor import MONITOR

    perc = small_perceiver
    frame = _frame("blurred", 96, 160, 1)
    MONITOR.clear()
    MONITOR.enable()
    try:
        out = perc.perceive(frame)
        taken = MONITOR.take()
    finally:
        MONITOR.disable()
        MONITOR.clear()
    assert taken["counters"] == {"perceiver.jpeg:host": 1, "segmenter.forward:fpn_resnet18": 1}
    assert "perceiver.jpeg" not in {s[0] for s in taken["spans"]}
    # the host path feeds the pipeline OpenCV's round trip, which the plain
    # version equals
    image = jrt.jpeg_round_trip_reference(torch.from_numpy(frame))
    drivable, _, _ = perc._pipeline(image)
    assert torch.equal(out["drivable"], drivable)


def test_the_agent_gate_counts_a_pair_of_launches_a_perceived_frame():
    # bench/agent_loop.py's gate: a camera frame perceived on the card is
    # one launch of each round-trip kernel beside its chain-edges launch;
    # an oracle mask launches neither
    from acmpc_tpu_torch.bench.agent_loop import _jpeg_fails
    from acmpc_tpu_torch.ops.track_chain import TRACK_CHAIN_EDGES

    pair = {jrt.BLOCKS_KERNEL: 7, jrt.COLOUR_KERNEL: 7}
    assert _jpeg_fails({TRACK_CHAIN_EDGES: 7, **pair}, camera=True) == []
    assert _jpeg_fails({TRACK_CHAIN_EDGES: 7}, camera=False) == []
    assert _jpeg_fails({TRACK_CHAIN_EDGES: 8, **pair}, camera=True)
    assert _jpeg_fails({TRACK_CHAIN_EDGES: 7, jrt.BLOCKS_KERNEL: 7, jrt.COLOUR_KERNEL: 6}, camera=True)
    assert _jpeg_fails({TRACK_CHAIN_EDGES: 7, **pair}, camera=False)
