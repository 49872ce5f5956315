"""The port's runtime shell pieces against the JAX package's (CPU): the
PIDs (exact: the same host arithmetic on Python floats), the mailbox, the
worker-thread template, the system monitor, the profiler hook and the
agent config of every track."""

import dataclasses
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from acmpc_tpu.config import load_config as j_load_config
from acmpc_tpu.runtime.pid import PID as JPID
from acmpc_tpu.runtime.pid import BrakePID as JBrakePID
from acmpc_tpu.runtime.pid import SteeringPID as JSteeringPID
from acmpc_tpu.runtime.pid import ThrottlePID as JThrottlePID
from acmpc_tpu_torch.config import PIDConfig, load_config
from acmpc_tpu_torch.runtime import (
    PID,
    BrakePID,
    Mailbox,
    SteeringPID,
    ThrottlePID,
    WorkerThread,
)
from acmpc_tpu_torch.utils.monitor import SystemMonitor, profile_trace, track_runtime

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRACKS = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))
PIDS = {"throttle": (ThrottlePID, JThrottlePID), "brake": (BrakePID, JBrakePID), "steering": (SteeringPID, JSteeringPID)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pid_sequence(seed: int, n: int = 400):
    """(current, target, now): speeds around the brake dead zone, and
    clock steps below the 0.01 s sample time (gated) and above it."""
    rng = np.random.default_rng(seed)
    current = rng.uniform(0.0, 40.0, n)
    target = current + rng.choice([-5.0, -1.5, -0.5, 0.0, 0.5, 1.0, 1.5, 5.0], n) + rng.normal(0.0, 0.3, n)
    steps = np.where(rng.random(n) < 0.3, rng.uniform(0.0, 0.009, n), rng.uniform(0.01, 0.2, n))
    return [(float(c), float(t), float(s)) for c, t, s in zip(current, target, np.cumsum(steps) + 1.0)]


@pytest.mark.parametrize("track", TRACKS)
def test_agent_config_equals_jax(track):
    path = ROOT / "configs" / f"{track}.yaml"
    ours, ref = load_config(path), j_load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for name in ("throttle_pid", "brake_pid", "steering_pid"):
        assert isinstance(getattr(ours, name), PIDConfig)
    assert (ours.map_path, ours.create_map, ours.n_mapping_laps) == (ref.map_path, ref.create_map, ref.n_mapping_laps)
    assert (ours.collect_images, ours.data_collection_path) == (ref.collect_images, ref.data_collection_path)


@pytest.mark.parametrize("kind", sorted(PIDS))
def test_pid_sequence_equals_jax(kind):
    cfg_path = ROOT / "configs" / "monza.yaml"
    ours_cls, ref_cls = PIDS[kind]
    ours = ours_cls(getattr(load_config(cfg_path), f"{kind}_pid"))
    ref = ref_cls(getattr(j_load_config(cfg_path), f"{kind}_pid"))
    seq = _pid_sequence(seed=len(kind))
    got = [ours(c, t, now) for c, t, now in seq]
    want = [ref(c, t, now) for c, t, now in seq]
    assert got == want  # exact
    # the sequence exercised the sample-time gate (a repeated output) and
    # both sides of the limits
    assert sum(a == b for a, b in zip(got[1:], got[:-1])) > 10
    if kind == "brake":
        assert max(got) == 1.0 and min(got) == 0.0
        # inside the dead zone a target just under the speed does not brake
        fresh = BrakePID(load_config(cfg_path).brake_pid)
        assert fresh(20.0, 19.5, now=1.0) == 0.0


def test_plain_pid_equals_jax_with_reset():
    ours, ref = PID(0.3, 0.7, 0.05, sample_time=0.02, output_limits=(-2.0, 3.0)), JPID(
        0.3, 0.7, 0.05, sample_time=0.02, output_limits=(-2.0, 3.0)
    )
    seq = _pid_sequence(seed=9, n=200)
    for i, (c, t, now) in enumerate(seq):
        if i == 100:
            ours.reset()
            ref.reset()
        assert ours(c, t, now) == ref(c, t, now)


def test_mailbox_latest_wins():
    box = Mailbox()
    assert box.is_stale(0.1)
    box.post(1)
    box.post(2)
    value, version, _ = box.read()
    assert value == 2 and version == 2
    value, version, _ = box.read_fresh(0, timeout=0.1)
    assert value == 2
    # the timeout path returns the stale value without blocking forever
    t0 = time.monotonic()
    value, version, _ = box.read_fresh(version, timeout=0.05)
    assert time.monotonic() - t0 < 1.0
    assert (value, version) == (2, 2)
    assert not box.is_stale(60.0)


def test_mailbox_wakes_a_blocked_reader():
    box = Mailbox()
    got = []
    reader = threading.Thread(target=lambda: got.append(box.read_fresh(0, timeout=10.0)))
    reader.start()
    time.sleep(0.05)
    box.post("fresh")
    reader.join(timeout=5.0)
    assert not reader.is_alive()
    assert got[0][:2] == ("fresh", 1)


class _Latest(WorkerThread):
    def _setup(self):
        self.calls = {"setup": threading.current_thread().name}
        self.seen = []
        self.done = threading.Event()

    def _runtime_setup(self):
        self.calls["runtime_setup"] = threading.current_thread().name

    def _work(self, item):
        self.seen.append(item)
        if item == "last":
            self.done.set()


def test_worker_processes_the_latest_item():
    worker = _Latest(name="acmpc-test-worker")
    assert worker.calls["setup"] == threading.current_thread().name
    # posted before the thread starts: only the latest is worked on
    for i in range(5):
        worker.submit(i)
    worker.submit("last")
    worker.start()
    assert worker.done.wait(timeout=10.0)
    assert worker.seen == ["last"]
    assert worker.calls["runtime_setup"] == "acmpc-test-worker"
    assert worker.is_running
    worker.stop()
    assert not worker.is_running and not worker.is_alive()


def test_system_monitor_percentiles():
    mon = SystemMonitor()

    @track_runtime(mon)
    def work():
        return 42

    for _ in range(10):
        assert work() == 42
    s = mon.summary("test_system_monitor_percentiles.<locals>.work")
    assert s["n"] == 10
    assert s["p99_ms"] >= s["p50_ms"] >= 0
    assert set(mon.all_summaries()) == {"test_system_monitor_percentiles.<locals>.work"}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as prof:
        torch.ones(8).add_(1.0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("add_" in e.key for e in prof.key_averages())
