"""Runtime monitoring: the port's one recorder of spans and counters.

Counterpart of ``acmpc_tpu/utils/monitor.py``: a SystemMonitor with a
``@track_runtime`` decorator and p50/p99 queries per tracked name, and a
context manager that wraps a region in a ``torch.profiler`` trace,
exported as a Chrome trace.

The process holds one monitor, ``MONITOR``, which the port's hot paths
open spans on. It is off by default.

- Off: ``span``, ``device_span`` and ``count`` cost one attribute read;
  the spans return one shared null context. Nothing is allocated, the
  clock is not read, no CUDA event is made and no operator range opened.
- On (``enable()``): ``span(name)`` records ``(name, start, end,
  parent, request)`` in memory on ``time.perf_counter()``, the clock the
  benchmark ties to the device trace. A span opened with no span open in
  its thread starts a new request id; a nested span takes its parent's
  name as ``parent`` and its request id. The stack is per thread.
  ``device_span(name, device)`` is the same host span plus a pair of
  timing events on the current stream of a CUDA ``device``: recorded now
  when eager, and as event-record nodes of the graph when the stream is
  being captured by ``ops/graph_loop.CapturedGraph``, so that every
  replay records them again. Its sample is the stream time between the
  two events, in ms, resolved without a synchronisation once the end
  event has completed: eager ones from a reused pool at ``take()`` (or
  when the pool runs dry), a graph's at the start of its next replay or
  at ``take()``. One not completed by then is dropped and counted in
  ``unresolved``. A capture made with the monitor off holds no event.
- ``take()`` returns what was recorded and clears it; ``clear()`` drops
  it.
- While ``profile_trace`` (or another caller inside ``operator_ranges``)
  runs a profiler with CPU activity, each span also opens
  ``torch.profiler.record_function(name)``, on or off, so that operator
  traces carry the same names.

The names, the contract the benchmark's readers key on ((d): a device
span):

| Layer | Spans and counters |
|---|---|
| perception (``perception/perceiver.py``) | ``perceiver.perceive``; ``perceiver.jpeg_encode``, ``perceiver.jpeg_decode``, ``perceiver.resize`` (only when it resizes), ``perceiver.upload``, ``perceiver.pipeline``; ``perceiver.segment`` (d), ``perceiver.extract`` (d) |
| compiled graphs (``ops/graph_loop.py``) | ``graph.inputs``, ``graph.replay``, ``graph.outputs``; counters ``graph.capture:<name>``, ``graph.replay:<name>`` |
| control step (``runtime/controller.py``, ``mpc/spatial_mpc.py``) | ``control.solve``; ``control.refit``, ``control.step``, ``control.publish``; ``mpc.shift`` (d), ``mpc.prepare`` (d), ``mpc.extract`` (d) |
| QP engine (``qp/admm.py``, ``qp/batched.py``) | ``qp.factor`` (d), ``qp.iterate`` (d), ``qp.read_done`` |
| sweep (``bench/lap_sweep.py``) | ``sweep.step``; ``sweep.window`` (d), ``sweep.integrate`` (d) |
| localisation (``localise/``) | ``nearest_point``, ``localiser.step``, ``localiser.observe`` |
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import pathlib
import threading
import time
from typing import Dict

import torch

# the default trace directory, in the checkout's (ignored) build tree
TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "acmpc_trace"

_NULL = contextlib.nullcontext()


class SystemMonitor:
    """Rolling per-name wall-time statistics, and while on, the spans,
    device samples and counters of the process."""

    def __init__(self, report_interval: int = 300, window: int = 2048):
        self.report_interval = report_interval
        self._samples: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._window = window
        self.verbosity = False
        self.enabled = False
        # on, or opening operator ranges: the one attribute an off span reads
        self.active = False
        self._ranges = 0
        self._local = threading.local()
        self._requests = itertools.count(1)
        self._lock = threading.Lock()
        self._free: list = []  # eager event pairs to reuse
        self._reset()

    def _reset(self):
        self.spans: list = []  # (name, start s, end s, parent, request)
        self.device: list = []  # (name, request, ms)
        self.counters: collections.Counter = collections.Counter()
        self.unresolved = 0
        self._eager: list = []  # (name, request, start, end) not yet resolved
        self._replays: dict = {}  # id(timers) -> (timers, request) of the last replay

    # -- switches ----------------------------------------------------------
    def enable(self):
        self.enabled = self.active = True

    def disable(self):
        self.enabled = False
        self.active = self._ranges > 0

    def clear(self):
        """Drop every span, sample and counter recorded so far, and the
        rolling statistics."""
        with self._lock:
            self._free += [(s, e) for _, _, s, e in self._eager]
            self._reset()
            self._samples.clear()
            self._counts.clear()

    def take(self) -> dict:
        """What was recorded since the last ``clear`` or ``take``, then
        clear: ``spans``, ``device`` (samples of every completed device
        span), ``counters`` and ``unresolved``. Resolves the samples whose
        end event has completed; synchronises nothing."""
        with self._lock:
            self._resolve_eager(final=True)
            for timers, request in self._replays.values():
                self._resolve_timers(timers, request)
            out = {"spans": self.spans, "device": self.device,
                   "counters": dict(self.counters), "unresolved": self.unresolved}
            self._reset()
        return out

    @contextlib.contextmanager
    def operator_ranges(self):
        """Inside: every span also opens ``torch.profiler.record_function``
        of its name (for a profiler with CPU activity)."""
        self._ranges += 1
        self.active = True
        try:
            yield
        finally:
            self._ranges -= 1
            self.active = self.enabled or self._ranges > 0

    # -- recording ---------------------------------------------------------
    def span(self, name: str):
        if not self.active:
            return _NULL
        return _Span(self, name, None)

    def device_span(self, name: str, device: torch.device):
        if not self.active:
            return _NULL
        return _Span(self, name, device)

    def count(self, name: str, n: int = 1):
        if self.enabled:
            with self._lock:
                self.counters[name] += n

    def record(self, name: str, seconds: float):
        if name not in self._samples:
            self._samples[name] = collections.deque(maxlen=self._window)
        self._samples[name].append(seconds)
        self._counts[name] += 1
        if self.verbosity and self._counts[name] % self.report_interval == 0:
            s = self.summary(name)
            print(
                f"[monitor] {name}: n={self._counts[name]} "
                f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms"
            )

    def _current_request(self):
        stack = getattr(self._local, "stack", None)
        return stack[-1][1] if stack else None

    # -- CUDA graphs (ops/graph_loop.CapturedGraph) -------------------------
    @contextlib.contextmanager
    def capturing(self):
        """Around a graph's capture: the device spans inside record their
        events as nodes of the graph and gather the pairs in the yielded
        list (empty with the monitor off), which the graph passes to
        ``replaying`` before each replay."""
        timers: list = []
        self._local.timers = timers
        try:
            yield timers
        finally:
            self._local.timers = None

    def replaying(self, timers: list):
        """Before a replay of a graph captured with ``timers``: resolve the
        samples of its last replay, and hold these for the request now
        open."""
        request = self._current_request()
        with self._lock:
            held = self._replays.pop(id(timers), None)
            if held is not None:
                self._resolve_timers(*held)
            self._replays[id(timers)] = (timers, request)

    def _resolve_timers(self, timers, request):
        for name, start, end in timers:
            if end.query():
                self.device.append((name, request, start.elapsed_time(end)))
            else:
                self.unresolved += 1

    def _resolve_eager(self, final: bool):
        pending = []
        for name, request, start, end in self._eager:
            if end.query():
                self.device.append((name, request, start.elapsed_time(end)))
            elif not final:
                pending.append((name, request, start, end))
                continue
            else:
                self.unresolved += 1
            self._free.append((start, end))
        self._eager = pending

    def _start_events(self, device):
        """Record a device span's start on ``device``'s current stream;
        returns what its end needs, or None (CPU, or a capture that
        ``capturing`` does not cover)."""
        if device.type != "cuda":
            return None
        stream = torch.cuda.current_stream(device)
        if torch.cuda.is_current_stream_capturing():
            timers = getattr(self._local, "timers", None)
            if timers is None:
                return None
            start = torch.cuda.Event(enable_timing=True, external=True)
            end = torch.cuda.Event(enable_timing=True, external=True)
            start.record(stream)
            return stream, start, end, timers
        with self._lock:
            if not self._free:
                self._resolve_eager(final=False)
            pair = self._free.pop() if self._free else (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record(stream)
        return stream, pair[0], pair[1], None

    def _end_events(self, name, request, events):
        stream, start, end, timers = events
        end.record(stream)
        if timers is not None:
            timers.append((name, start, end))
        else:
            with self._lock:
                self._eager.append((name, request, start, end))

    # -- statistics ----------------------------------------------------------
    def summary(self, name: str) -> Dict[str, float]:
        import numpy as np

        data = np.asarray(self._samples.get(name, [0.0]))
        return {
            "n": self._counts[name],
            "p50_ms": float(np.percentile(data, 50) * 1e3),
            "p99_ms": float(np.percentile(data, 99) * 1e3),
            "mean_ms": float(data.mean() * 1e3),
            "max_ms": float(data.max() * 1e3),
        }

    def all_summaries(self) -> Dict[str, Dict[str, float]]:
        return {name: self.summary(name) for name in self._samples}


class _Span:
    """One open span of a monitor that is on (or opening ranges)."""

    __slots__ = ("monitor", "name", "device", "range", "frame", "parent", "events", "t0")

    def __init__(self, monitor: SystemMonitor, name: str, device):
        self.monitor, self.name, self.device = monitor, name, device

    def __enter__(self):
        m = self.monitor
        self.range = self.frame = self.events = None
        if m._ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if m.enabled:
            stack = getattr(m._local, "stack", None)
            if stack is None:
                stack = m._local.stack = []
            self.parent = stack[-1] if stack else None
            request = self.parent[1] if self.parent else next(m._requests)
            self.frame = (self.name, request)
            stack.append(self.frame)
            if self.device is not None:
                self.events = m._start_events(self.device)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        m = self.monitor
        if self.frame is not None:
            t1 = time.perf_counter()
            name, request = self.frame
            if self.events is not None:
                m._end_events(name, request, self.events)
            m._local.stack.pop()
            with m._lock:
                m.spans.append((name, self.t0, t1, self.parent and self.parent[0], request))
                m.record(name, t1 - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


# the process's monitor, off until enabled
MONITOR = SystemMonitor()


def track_runtime(monitor: SystemMonitor):
    """Decorator recording each call's wall time."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                monitor.record(fn.__qualname__, time.perf_counter() - t0)

        return wrapper

    return decorator


@contextlib.contextmanager
def profile_trace(log_dir: str | pathlib.Path = TRACE_DIR):
    """Wrap a region in a ``torch.profiler`` trace of the host and, where
    there is a card, of the card, with ``MONITOR``'s spans as operator
    ranges; on exit the trace is written to ``<log_dir>/trace.json``
    (Chrome trace format, viewable in Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with MONITOR.operator_ranges(), torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
