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
