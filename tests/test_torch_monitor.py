"""The port's recorder (``utils/monitor.py``): off it records nothing and
costs one attribute read; on it records nested spans with their parents
and request ids per thread, and counters; operator ranges open only
under ``profile_trace`` (or ``locbench``'s profile); and the hot paths'
eager CPU runs carry the span names the benchmark's readers key on.
The CUDA side (events in captured graphs) is in ``test_torch_cuda.py``.
"""

import pathlib
import threading
import types

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.utils import monitor as monitor_module
from acmpc_tpu_torch.utils.monitor import MONITOR, SystemMonitor, profile_trace

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def recording():
    """The process's monitor on for one test, off and empty after it."""
    MONITOR.clear()
    MONITOR.enable()
    try:
        yield MONITOR
    finally:
        MONITOR.disable()
        MONITOR.clear()


def _parents(spans) -> dict:
    """name -> the set of parent names it was seen under."""
    out: dict = {}
    for name, _, _, parent, _ in spans:
        out.setdefault(name, set()).add(parent)
    return out


def test_monitor_is_off_by_default():
    assert not MONITOR.enabled and not MONITOR.active


def test_off_monitor_records_nothing_and_makes_no_event_or_range(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("the off monitor made an object it should not")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(monitor_module, "time", types.SimpleNamespace(perf_counter=forbidden))
    mon = SystemMonitor()
    # one shared null context, whatever the name or device
    assert mon.span("a") is mon.span("b") is mon.device_span("c", torch.device("cpu"))
    with mon.span("a"):
        with mon.device_span("b", torch.device("cuda", 0)):
            mon.count("n", 3)
    assert mon.take() == {"spans": [], "device": [], "counters": {}, "unresolved": 0}
    assert mon.all_summaries() == {}


def test_on_monitor_nests_spans_and_shares_request_ids(recording):
    with recording.span("root"):
        with recording.span("child"):
            with recording.device_span("leaf", torch.device("cpu")):
                recording.count("hits")
        with recording.span("child"):
            recording.count("hits", 2)
    with recording.span("root"):
        pass
    out = recording.take()
    names = [s[0] for s in out["spans"]]
    assert names == ["leaf", "child", "child", "root", "root"]
    by = {(s[0], s[4]): s for s in out["spans"]}
    first, second = out["spans"][3][4], out["spans"][4][4]
    assert first != second
    assert by[("leaf", first)][3] == "child" and by[("root", first)][3] is None
    assert all(s[4] == first for s in out["spans"][:4])
    for _, t0, t1, _, _ in out["spans"]:
        assert t1 >= t0
    leaf, root = by[("leaf", first)], by[("root", first)]
    assert root[1] <= leaf[1] <= leaf[2] <= root[2]
    # a CPU device span records its host part alone
    assert out["device"] == [] and out["unresolved"] == 0
    assert out["counters"] == {"hits": 3}
    # take() cleared what it returned; the summaries read the same store
    assert recording.take()["spans"] == []
    assert recording.summary("child")["n"] == 2


def test_request_ids_are_per_thread(recording):
    ready, go = threading.Barrier(2), threading.Event()

    def worker():
        with recording.span("control.solve"):
            ready.wait(timeout=10)
            go.wait(timeout=10)
            with recording.span("control.step"):
                pass

    thread = threading.Thread(target=worker)
    thread.start()
    with recording.span("perceiver.perceive"):
        ready.wait(timeout=10)
        with recording.span("perceiver.upload"):
            go.set()
            thread.join(timeout=10)
    assert not thread.is_alive()
    spans = {s[0]: s for s in recording.take()["spans"]}
    assert spans["control.step"][3] == "control.solve"
    assert spans["perceiver.upload"][3] == "perceiver.perceive"
    assert spans["control.step"][4] == spans["control.solve"][4]
    assert spans["perceiver.upload"][4] == spans["perceiver.perceive"][4]
    assert spans["control.solve"][4] != spans["perceiver.perceive"][4]


def test_threads_lose_no_span_or_count(recording):
    """More threads than cores, switching as often as the interpreter
    allows: every span and count of every thread is kept, each thread's
    nested spans under its own root's request."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 2) + 2, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with recording.span("root"):
                    with recording.span("leaf"):
                        recording.count("hits")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    out = recording.take()
    total = n_threads * n_spans
    assert out["counters"] == {"hits": total}
    roots = {s[4]: s for s in out["spans"] if s[0] == "root"}
    leaves = [s for s in out["spans"] if s[0] == "leaf"]
    assert len(roots) == len(leaves) == total
    for leaf in leaves:
        root = roots[leaf[4]]
        assert leaf[3] == "root" and root[1] <= leaf[1] <= leaf[2] <= root[2]
    assert recording.summary("leaf")["n"] == total


def test_clear_drops_spans_counters_and_summaries(recording):
    with recording.span("a"):
        recording.count("b")
    recording.clear()
    assert recording.take() == {"spans": [], "device": [], "counters": {}, "unresolved": 0}
    assert recording.all_summaries() == {}
    # still on after a clear
    with recording.span("c"):
        pass
    assert [s[0] for s in recording.take()["spans"]] == ["c"]


def _range_names(prof) -> set:
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("on", [False, True])
def test_operator_ranges_open_only_under_profile_trace(tmp_path, on):
    if on:
        MONITOR.enable()
    try:
        # a profiler the monitor was not asked to annotate sees no range
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as plain:
            with MONITOR.span("monitor.test_range"):
                torch.ones(4).add_(1.0)
        assert "monitor.test_range" not in _range_names(plain)
        with profile_trace(tmp_path / "trace") as traced:
            with MONITOR.span("monitor.test_range"):
                torch.ones(4).add_(1.0)
        assert "monitor.test_range" in _range_names(traced)
        # the ranges end with the trace
        assert MONITOR.active == on
        assert "monitor.test_range" in (tmp_path / "trace" / "trace.json").read_text()
    finally:
        MONITOR.disable()
        MONITOR.clear()


# -- the span sites of the hot paths, eagerly on the CPU ----------------------


def test_perceive_spans(recording):
    from acmpc_tpu_torch.bench.perception_loop import perception_config
    from acmpc_tpu_torch.perception.perceiver import Perceiver

    perc = Perceiver(perception_config(160, 96, "fp32"), device="cpu")
    # another size than the configured one: the resize runs too
    frame = np.random.default_rng(0).integers(0, 255, (120, 200, 3), dtype=np.uint8)
    recording.clear()
    perc.perceive(frame)
    out = recording.take()
    assert _parents(out["spans"]) == {
        "perceiver.perceive": {None},
        "perceiver.jpeg_encode": {"perceiver.perceive"},
        "perceiver.jpeg_decode": {"perceiver.perceive"},
        "perceiver.resize": {"perceiver.perceive"},
        "perceiver.upload": {"perceiver.perceive"},
        "perceiver.pipeline": {"perceiver.perceive"},
        "perceiver.segment": {"perceiver.pipeline"},
        "perceiver.extract": {"perceiver.pipeline"},
    }
    assert len({s[4] for s in out["spans"]}) == 1
    # at the configured size nothing is resized
    perc.perceive(frame[:96, :160])
    assert "perceiver.resize" not in _parents(recording.take()["spans"])


def test_control_solve_spans(recording):
    from acmpc_tpu_torch.config.schema import load_config
    from acmpc_tpu_torch.runtime.controller import Controller, _ControlThread

    cfg = load_config(ROOT / "configs" / "monza.yaml")
    controller = Controller(cfg, device="cpu")
    controller.is_mapping = False
    centreline = np.stack([np.zeros(120), np.linspace(2.0, 120.0, 120)], axis=1).astype(np.float32)
    thread = _ControlThread(controller)
    recording.clear()
    thread._solve(centreline, 0.0)
    out = recording.take()
    assert _parents(out["spans"]) == {
        "control.solve": {None},
        "control.refit": {"control.solve"},
        "control.step": {"control.solve"},
        "control.publish": {"control.solve"},
        "mpc.prepare": {"control.step"},
        "qp.factor": {"control.step"},
        "qp.iterate": {"control.step"},
        "mpc.extract": {"control.step"},
    }
    assert controller.command_version == 1


def test_fused_step_spans(recording):
    from acmpc_tpu_torch.bench import LapSweep, SweepGrid
    from acmpc_tpu_torch.bench.batch_sweep import make_mpc
    from acmpc_tpu_torch.bench.perception_loop import circuit
    from acmpc_tpu_torch.localise.track_map import TrackMap

    centre, left, right, _ = circuit(400)
    tm = TrackMap(*(torch.tensor(v, dtype=torch.float32) for v in (centre, left, right)))
    sweep = LapSweep(make_mpc(12, "cpu"), tm, half_width=5.0, dt=0.1)
    grid = SweepGrid.regular(3, tm.centre.shape[0], device="cpu")
    cars, states, i0 = sweep.start(grid)
    recording.clear()
    sweep.fused_step(cars, states, grid.v_max, i0)
    out = recording.take()
    parents = _parents(out["spans"])
    assert parents == {
        "sweep.step": {None},
        "sweep.window": {"sweep.step"},
        "mpc.shift": {"sweep.step"},
        "mpc.prepare": {"sweep.step"},
        "qp.factor": {"sweep.step"},
        "qp.iterate": {"sweep.step"},
        "mpc.extract": {"sweep.step"},
        "sweep.integrate": {"sweep.step"},
    }
    # each span once a step: the chunk loop (ops/graph_loop.device_while,
    # a WHILE node under a capture) opens none of its own
    assert sorted(s[0] for s in out["spans"]) == sorted(parents)


def test_locbench_profile_reads_the_filter_spans():
    from acmpc_tpu_torch.bench import locbench

    out = locbench.profile(observations=2, device="cpu")
    calls = {name: row["calls"] for name, row in out["per_call"].items()}
    assert calls["localiser.observe"] == out["observations"] >= 2
    assert calls["localiser.step"] == out["steps"]
    # update's three nearest-neighbour queries sit in one range a call
    assert calls["nearest_point"] >= out["observations"]
    assert not MONITOR.active
