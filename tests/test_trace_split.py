"""``tools/trace_split.py``'s arithmetic on hand-made data: idle gaps
labelled by the benchmark span and the innermost program span that hold
their midpoints, and the per-layer numbers read from the monitor's spans
per request (left out where the spans or samples are absent)."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("trace_split", ROOT / "tools" / "trace_split.py")
trace_split = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_split)


def _span(name, t0, t1, parent=None, request=1):
    return (name, t0, t1, parent, request)


# one benchmark request "perceive" from 10 to 20 s on the host clock; the
# device clock runs 100 s ahead
OFFSET = 100.0
BENCH = [("perceive", 10.0, 20.0), ("control_solve", 20.0, 25.0)]
PROGRAM = [
    _span("perceiver.perceive", 10.0, 19.0),
    _span("perceiver.jpeg_encode", 10.0, 12.0, "perceiver.perceive"),
    _span("perceiver.jpeg_decode", 12.0, 14.0, "perceiver.perceive"),
    _span("perceiver.upload", 14.0, 15.0, "perceiver.perceive"),
    _span("perceiver.pipeline", 15.0, 19.0, "perceiver.perceive"),
    _span("graph.replay", 15.5, 16.0, "perceiver.pipeline"),
]


@pytest.mark.parametrize(
    "gap, label",
    [
        ((110.5, 111.5), "perceive/perceiver.jpeg_encode"),
        ((112.0, 114.0), "perceive/perceiver.jpeg_decode"),
        ((114.2, 114.6), "perceive/perceiver.upload"),
        ((115.6, 115.8), "perceive/graph.replay"),  # the innermost of three
        ((116.5, 118.5), "perceive/perceiver.pipeline"),
        ((119.2, 119.8), "perceive"),  # inside the request, outside the program
        ((121.0, 123.0), "control_solve"),
        ((130.0, 131.0), "harness"),
        ((105.0, 106.0), "harness"),
    ],
)
def test_gap_labels(gap, label):
    assert trace_split.label_gaps([gap], OFFSET, BENCH, PROGRAM) == {label: pytest.approx(gap[1] - gap[0])}


def test_gap_labels_sum_over_gaps_in_any_order():
    gaps = [(116.5, 118.5), (110.5, 111.5), (110.2, 110.4), (121.0, 123.0)]
    got = trace_split.label_gaps(gaps, OFFSET, list(reversed(BENCH)), list(reversed(PROGRAM)))
    assert got == pytest.approx({
        "perceive/perceiver.jpeg_encode": 1.2,
        "perceive/perceiver.pipeline": 2.0,
        "control_solve": 2.0,
    })


def test_gap_labels_without_program_spans_are_the_benchmarks():
    assert trace_split.label_gaps([(111.0, 112.0)], OFFSET, BENCH, []) == {"perceive": pytest.approx(1.0)}


def _taken(spans, device, counters=None):
    return {"spans": spans, "device": device, "counters": counters or {}, "unresolved": 0}


def test_layer_numbers_per_request():
    # two requests of the camera: host spans in s, device samples in ms
    spans = [
        _span("perceiver.jpeg_encode", 0.0, 0.004), _span("perceiver.jpeg_decode", 0.004, 0.010),
        _span("perceiver.upload", 0.010, 0.011), _span("graph.inputs", 0.011, 0.0112),
        _span("graph.outputs", 0.013, 0.0131),
        _span("perceiver.jpeg_encode", 1.0, 1.002, request=2), _span("perceiver.jpeg_decode", 1.002, 1.006, request=2),
        _span("perceiver.upload", 1.006, 1.009, request=2), _span("graph.inputs", 1.009, 1.0093, request=2),
        _span("graph.outputs", 1.010, 1.0105, request=2),
        _span("mpc.prepare", 0.02, 0.03), _span("qp.factor", 0.03, 0.04), _span("qp.iterate", 0.04, 0.05),
    ]
    device = [("perceiver.segment", 1, 2.0), ("perceiver.segment", 2, 2.5), ("perceiver.extract", 1, 0.1),
              ("perceiver.extract", 2, 0.3), ("mpc.prepare", 1, 0.4), ("qp.factor", 1, 0.6),
              ("qp.iterate", 1, 0.2), ("mpc.prepare", 2, 0.4), ("qp.factor", 2, 0.6), ("qp.iterate", 2, 0.2)]
    spans += [_span("perceiver.segment", 0, 0), _span("perceiver.extract", 0, 0)]
    program = trace_split.per_request(_taken(spans, device, {"graph.capture:x": 1, "graph.replay:x": 4}), 2)
    got = trace_split.layer_numbers(program, 1)
    assert got == pytest.approx({
        "jpeg_ms": 8.0,
        "upload_ms": 2.0,
        "segment_device_ms": 2.25,
        "extract_device_ms": 0.2,
        "graph_io_ms.b1": 0.55,
        "prepare_device_ms.b1": 0.4,
        "factor_device_ms.b1": 0.6,
        "iterate_device_ms.b1": 0.2,
        "graph_captures": 1,
    })
    sums = trace_split.bounding_sums(got, {"perception": [0.012, 0.012], "control": [0.0015]}, [0.02])
    assert set(sums) == {"jpeg+upload <= perception_ms", "b1 device <= control_ms.b1"}
    assert sums["jpeg+upload <= perception_ms"] == pytest.approx((10.0, 12.0))
    assert sums["b1 device <= control_ms.b1"] == pytest.approx((1.2, 1.5))


def test_layer_numbers_leave_out_what_was_not_recorded():
    # host spans of device spans with no sample (a CPU run): no device number
    spans = [_span(n, 0.0, 0.001) for n in ("sweep.window", "mpc.shift", "mpc.prepare")]
    got = trace_split.layer_numbers(trace_split.per_request(_taken(spans, []), 1), 256)
    assert got == {"graph_captures": 0}
    got = trace_split.layer_numbers(trace_split.per_request(_taken([], []), 0), 1)
    assert got == {"graph_captures": 0}
    lap = [("sweep.window", 1, 1.0), ("mpc.shift", 1, 0.5), ("sweep.integrate", 1, 0.25)]
    spans += [_span("sweep.integrate", 0.0, 0.001)]
    got = trace_split.layer_numbers(trace_split.per_request(_taken(spans, lap + [("mpc.prepare", 1, 2.0)]), 1), 256)
    assert got == pytest.approx({"lap_device_ms.b256": 1.75, "prepare_device_ms.b256": 2.0, "graph_captures": 0})


def test_layer_numbers_of_the_round_trip_on_the_card():
    # the card's path: no host JPEG spans, the round trip a device sample a
    # replay (its host span only at the capture)
    spans = [
        _span("perceiver.upload", 0.0, 0.0005), _span("perceiver.upload", 1.0, 1.0003, request=2),
        _span("perceiver.jpeg", 0.0, 0.0),
    ]
    device = [("perceiver.jpeg", 1, 0.02), ("perceiver.jpeg", 2, 0.03), ("perceiver.segment", 1, 2.0),
              ("perceiver.segment", 2, 2.0)]
    program = trace_split.per_request(_taken(spans, device, {"perceiver.jpeg:device": 2}), 2)
    got = trace_split.layer_numbers(program, 1)
    assert got == pytest.approx({"jpeg_device_ms": 0.025, "upload_ms": 0.4, "segment_device_ms": 2.0,
                                 "graph_captures": 0})
    assert "jpeg_ms" not in got
    assert trace_split.bounding_sums(got, {"perception": [0.005]}, [0.01]) == {}
    # samples with no host span at all (a window after the capture) still count
    program = trace_split.per_request(_taken([], device[:2]), 2)
    assert trace_split.layer_numbers(program, 1) == pytest.approx({"jpeg_device_ms": 0.025, "graph_captures": 0})


def test_layer_numbers_of_segformer_spans():
    # two frames: four stage samples, the head's and 16 attention samples
    # each (one a block), nested under the segmenter's device span
    device = []
    for request in (1, 2):
        device += [("perceiver.segment", request, 4.0), ("segformer.decode", request, 1.5)]
        device += [(f"segformer.stage{i}", request, 0.5) for i in range(1, 5)]
        device += [("segformer.attention", request, 0.05)] * 16
    program = trace_split.per_request(_taken([], device, {"segmenter.forward:segformer_b2": 2}), 2)
    got = trace_split.layer_numbers(program, 1)
    assert got == pytest.approx({
        "segment_device_ms": 4.0, "segformer_stage1_device_ms": 0.5, "segformer_stage2_device_ms": 0.5,
        "segformer_stage3_device_ms": 0.5, "segformer_stage4_device_ms": 0.5, "segformer_decode_device_ms": 1.5,
        "segformer_attention_device_ms": 0.8, "graph_captures": 0})
    assert program["counters"] == {"segmenter.forward:segformer_b2": 2}
    sums = trace_split.bounding_sums(got, {}, [0.005])
    assert sums == {"segformer stages + decode <= segment_device_ms": pytest.approx((3.5, 4.0))}


def test_layer_numbers_of_mask2former_spans():
    # two frames: the four stages' samples, six deformable and nine masked
    # attention samples each (one a layer), under the segmenter's span
    device = []
    for request in (1, 2):
        device += [("perceiver.segment", request, 10.0), ("mask2former.backbone", request, 3.0),
                   ("mask2former.pixel_decoder", request, 4.0), ("mask2former.decoder", request, 2.0),
                   ("mask2former.semantic", request, 0.5)]
        device += [("mask2former.deform_attn", request, 0.25)] * 6
        device += [("mask2former.masked_attention", request, 0.1)] * 9
    program = trace_split.per_request(_taken([], device, {"segmenter.forward:mask2former_r50": 2}), 2)
    got = trace_split.layer_numbers(program, 1)
    assert got == pytest.approx({
        "segment_device_ms": 10.0, "mask2former_backbone_device_ms": 3.0, "mask2former_pixel_decoder_device_ms": 4.0,
        "mask2former_deform_attn_device_ms": 1.5, "mask2former_decoder_device_ms": 2.0,
        "mask2former_masked_attention_device_ms": 0.9, "mask2former_semantic_device_ms": 0.5, "graph_captures": 0})
    assert program["counters"] == {"segmenter.forward:mask2former_r50": 2}
    assert trace_split.bounding_sums(got, {}, [0.012]) == {
        "mask2former stages <= segment_device_ms": pytest.approx((9.5, 10.0)),
        "mask2former_deform_attn <= mask2former_pixel_decoder": pytest.approx((1.5, 4.0)),
        "mask2former_masked_attention <= mask2former_decoder": pytest.approx((0.9, 2.0)),
    }


def test_layer_numbers_of_swin_spans():
    # two frames: Swin-L's four stages and its 24 window attentions (one a
    # block) under Mask2Former's backbone span
    device = []
    for request in (1, 2):
        device += [("perceiver.segment", request, 12.0), ("mask2former.backbone", request, 5.0),
                   ("mask2former.pixel_decoder", request, 4.0), ("mask2former.decoder", request, 2.0),
                   ("mask2former.semantic", request, 0.5)]
        device += [(f"swin.stage{i}", request, ms) for i, ms in ((1, 1.0), (2, 0.5), (3, 2.5), (4, 0.25))]
        device += [("swin.window_attention", request, 0.02)] * 24
    program = trace_split.per_request(_taken([], device, {"segmenter.forward:mask2former_swin_l": 2}), 2)
    got = trace_split.layer_numbers(program, 1)
    assert {k: v for k, v in got.items() if k.startswith("swin")} == pytest.approx({
        "swin_stage1_device_ms": 1.0, "swin_stage2_device_ms": 0.5, "swin_stage3_device_ms": 2.5,
        "swin_stage4_device_ms": 0.25, "swin_window_attention_device_ms": 0.48})
    sums = trace_split.bounding_sums(got, {}, [0.015])
    assert sums["swin stages <= mask2former_backbone"] == pytest.approx((4.25, 5.0))
    assert sums["mask2former stages <= segment_device_ms"] == pytest.approx((11.5, 12.0))
    # a stage without samples leaves the stages' sum out
    del program["spans"]["swin.stage4"]
    assert "swin stages <= mask2former_backbone" not in trace_split.bounding_sums(
        trace_split.layer_numbers(program, 1), {}, [0.015])
