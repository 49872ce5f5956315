"""Runtime monitoring: latency tracking and a torch.profiler hook.

Counterpart of ``acmpc_tpu/utils/monitor.py``: a per-module
SystemMonitor with a ``@track_runtime`` decorator and p50/p99 queries
per tracked function, and a context manager that wraps a region in a
``torch.profiler`` trace, exported as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import pathlib
import time
from typing import Dict

# the default trace directory, in the checkout's (ignored) build tree
TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "acmpc_trace"

class SystemMonitor:
    """Rolling per-function wall-time statistics."""

    def __init__(self, report_interval: int = 300, window: int = 2048):
        self.report_interval = report_interval
        self._samples: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._window = window
        self.verbosity = False

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
    there is a card, of the card; on exit the trace is written to
    ``<log_dir>/trace.json`` (Chrome trace format, viewable in Perfetto).
    Yields the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
