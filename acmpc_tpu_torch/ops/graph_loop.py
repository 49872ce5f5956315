"""Compiled entry points on the card: CUDA graphs, and the loop that runs
inside one.

The counterpart of ``jax.jit`` and ``lax.while_loop``. JAX compiles its
hot paths into one device program and replays it; the port captures
them as CUDA graphs (:class:`CapturedGraph`, one per input signature in
:class:`GraphCache`). A capture records the kernels the eager code
queues, so a loop whose stopping test reads the card back cannot be
captured as it is: :func:`device_while` is that loop with the test left
on the card. Eagerly (on the CPU, and on the card outside a capture) it
is the host loop; under a capture it is one WHILE conditional node of
the graph (``csrc/graph_loop.cu``), whose body is captured once and runs
until its flag is false, with no host read.

The body is captured on a second stream into the node's body graph, and
its allocations must land in the capturing graph's private memory pool,
as PyTorch's own ``CUDAGraph::begin_capture_to_if_node`` arranges for an
IF node: for the body's capture the pool takes the second stream's
allocations in place of the first's, and after it the first's again.

Launch counts. A wrapper that counts its kernel's launches
(``admm_chunk.launches``, ``chain_edges.launches``) counts through
:func:`count_launch`. Eagerly that adds one. During a capture nothing is
launched: the capture records the kernel, and every replay adds it
(kernels outside any loop at the replay; kernels in a loop body once a
trip, from a running count of the trips that the body's last kernel
keeps on the card, added by :func:`settle_launches`, which reads the
card once).

Everything is made at first use: the library, the streams, the graphs.
The CPU tests import this module with no CUDA present.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import gc
import threading
import weakref

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.utils.monitor import MONITOR

SOURCE = "graph_loop.cu"
SET_CONDITION = "graph_loop_set_condition"
# CUDA 12.4 brought conditional WHILE nodes
MIN_CUDA = 12040
# loops one graph may hold (the trip counters made before its capture)
MAX_LOOPS = 8
# the capture mode of every graph and loop body: thread_local, so that
# the other threads of the runtime may allocate and synchronise while one
# captures (cudaStreamCaptureModeThreadLocal)
CAPTURE_MODE = "thread_local"
_MODE_CODE = {"global": 0, "thread_local": 1, "relaxed": 2}

_local = threading.local()
_graphs: "weakref.WeakSet[CapturedGraph]" = weakref.WeakSet()


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The loop's library for one card; raises where the toolkit or the
    driver is older than CUDA 12.4."""
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.graph_loop_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_loop_begin.argtypes = [
        ctypes.c_void_p,  # the capturing stream
        ctypes.c_void_p,  # the entry flag (bool)
        ctypes.c_void_p,  # the body's stream
        ctypes.c_int,  # the body capture's mode
        ctypes.POINTER(ctypes.c_ulonglong),  # the node's handle
    ]
    lib.graph_loop_end.argtypes = [
        ctypes.c_void_p,  # the body's stream
        ctypes.c_ulonglong,  # the node's handle
        ctypes.c_void_p,  # the flag after a trip (bool), or null
        ctypes.c_void_p,  # the trip counter (int64)
    ]
    for fn in (lib.graph_loop_versions, lib.graph_loop_begin, lib.graph_loop_end):
        fn.restype = ctypes.c_int
    runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.graph_loop_versions(ctypes.byref(runtime), ctypes.byref(driver))
    if err != 0:
        raise RuntimeError(f"graph_loop: CUDA error {err} reading the CUDA versions")
    if min(runtime.value, driver.value) < MIN_CUDA:
        raise RuntimeError(
            f"device_while needs CUDA 12.4 or later (WHILE conditional nodes): "
            f"runtime {runtime.value}, driver {driver.value}"
        )
    lib.versions = {"runtime": runtime.value, "driver": driver.value}
    return lib


def cuda_versions(device_index: int = 0) -> dict:
    """The CUDA runtime's and driver's versions the loop's library sees
    (building it), e.g. ``{"runtime": 12080, "driver": 12080}``."""
    return _library(device_index).versions


def _streams(device: torch.device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
    """This thread's (capture, loop body) streams on ``device``: two
    threads may capture at once, and a stream captures one graph at a
    time."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device.index not in streams:
        streams[device.index] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return streams[device.index]


class _Capture:
    """What one capture in progress records: its pool, the tallies of
    counted launches (a stack: the graph's own, then one a loop being
    captured), the loops and their trip counters."""

    def __init__(self, device: torch.device, body_stream: torch.cuda.Stream):
        self.body_stream = body_stream
        self.pool = None  # the graph's memory pool
        # made before the capture begins, so outside the graph's pool and
        # zeroed once: running totals across replays
        self.trips = torch.zeros(MAX_LOOPS, dtype=torch.int64, device=device)
        self.tallies: list[list] = [[]]
        self.loops: list[tuple[int, list]] = []


def count_launch(counter: collections.Counter, name: str) -> None:
    """Count one launch of kernel ``name`` in ``counter``: now, or, under a
    capture made by :class:`CapturedGraph`, at every replay that runs it."""
    capture = getattr(_local, "capture", None)
    if capture is None:
        counter[name] += 1
    else:
        capture.tallies[-1].append((counter, name))


def _route_allocations(device_index: int, pool, stream: torch.cuda.Stream) -> None:
    """Send the pool's allocations from ``stream`` alone: the capturing
    stream's routing is dropped and ``stream``'s set (PyTorch's allocator
    keeps one routing per pool)."""
    C = torch._C
    end = getattr(C, "_cuda_endAllocateToPool", None) or C._cuda_endAllocateCurrentStreamToPool
    end(device_index, pool)
    with torch.cuda.stream(stream):
        C._cuda_beginAllocateCurrentStreamToPool(device_index, pool)
    # each begin takes a reference on the pool; the graph holds its own
    C._cuda_releasePool(device_index, pool)


def device_while(cond, body, carry):
    """``lax.while_loop(cond, body, carry)``: while ``cond(carry)`` (a
    0-d bool tensor) holds, ``carry = body(carry)``; returns the last
    carry. ``carry`` is a tuple of tensors; ``body`` returns one of the
    same shapes and dtypes.

    Eagerly, on the CPU or on the card outside a capture, the host reads
    the flag once a trip. Under a :class:`CapturedGraph` capture the loop
    is one WHILE node: the carry is copied into buffers of the graph, the
    body is captured once on a second stream, writes its result back into
    those buffers, and its last kernel sets the node's flag from
    ``cond``, so the card runs the trips with no host read. A capture
    that this module did not start raises."""
    carry = tuple(carry)
    device = carry[0].device
    if device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        while bool(cond(carry)):
            carry = tuple(body(carry))
        return carry
    capture = getattr(_local, "capture", None)
    if capture is None:
        raise RuntimeError("device_while under a CUDA graph capture that graph_loop did not start")
    if len(capture.tallies) > 1:
        raise RuntimeError("device_while inside a device_while body is not supported")
    slot = len(capture.loops)
    if slot == MAX_LOOPS:
        raise RuntimeError(f"a graph holds at most {MAX_LOOPS} device loops")
    lib = _library(device.index)
    stream = torch.cuda.current_stream(device)
    body_stream = capture.body_stream
    # the loop's own buffers: the body writes them and the caller's carry
    # stays as it was
    carry = tuple(t.clone() for t in carry)
    count_launch(device_while.launches, SET_CONDITION)
    handle = ctypes.c_ulonglong(0)
    entry = cond(carry)
    err = lib.graph_loop_begin(
        stream.cuda_stream, entry.data_ptr(), body_stream.cuda_stream,
        _MODE_CODE[CAPTURE_MODE], ctypes.byref(handle),
    )
    if err != 0:
        raise RuntimeError(f"device_while: adding the WHILE node failed: CUDA error {err}")
    _route_allocations(device.index, capture.pool, body_stream)
    tally: list = []
    capture.tallies.append(tally)
    flag = None
    try:
        with torch.cuda.stream(body_stream):
            new = tuple(body(carry))
            if len(new) != len(carry):
                raise ValueError(f"body returned {len(new)} tensors for a carry of {len(carry)}")
            for buffer, value in zip(carry, new):
                if value.shape != buffer.shape or value.dtype != buffer.dtype:
                    raise ValueError(
                        f"body changed a carry tensor from {tuple(buffer.shape)} {buffer.dtype} "
                        f"to {tuple(value.shape)} {value.dtype}"
                    )
                buffer.copy_(value)
            flag = cond(carry)
            count_launch(device_while.launches, SET_CONDITION)
    finally:
        capture.tallies.pop()
        err = lib.graph_loop_end(
            body_stream.cuda_stream, handle.value,
            None if flag is None else flag.data_ptr(), capture.trips[slot].data_ptr(),
        )
        _route_allocations(device.index, capture.pool, stream)
    if err != 0:
        raise RuntimeError(f"device_while: ending the loop body failed: CUDA error {err}")
    capture.loops.append((slot, tally))
    return carry


device_while.launches = collections.Counter()


class CapturedGraph:
    """``fn`` over a fixed list of device tensors, captured once as a CUDA
    graph and replayed.

    At construction: the inputs are copied into the graph's static
    buffers, ``fn`` runs once eagerly on a side stream (libraries built,
    cuBLAS and cuSOLVER handles and workspaces made, cuDNN's algorithms
    chosen, the kernels' caches filled), then is captured in
    ``thread_local`` mode. A capture that fails raises with its reason;
    nothing runs eagerly in its place. ``__call__`` copies the inputs in,
    replays, and returns clones of the outputs: a later replay never
    overwrites what a caller holds. One thread replays a graph at a time.

    With ``utils/monitor.MONITOR`` on, the three steps of a call are its
    spans ``graph.inputs``, ``graph.replay`` and ``graph.outputs``, and it
    counts ``graph.capture:<name>`` and ``graph.replay:<name>``. The
    device spans that ``fn`` opens while it is captured are event-record
    nodes of the graph (with the monitor off there are none), whose
    samples the monitor resolves at the next replay.
    """

    def __init__(self, fn, inputs, name: str = "graph"):
        inputs = list(inputs)
        self.name = name
        self.device = inputs[0].device
        self._lock = threading.Lock()
        capture_stream, body_stream = _streams(self.device)
        current = torch.cuda.current_stream(self.device)
        self.static_inputs = [t.detach().clone() for t in inputs]
        capture_stream.wait_stream(current)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(capture_stream):
            fn(*self.static_inputs)  # warm-up
            capture = _Capture(self.device, body_stream)
            # a pool named before the capture: the loops route the body's
            # allocations to it while the capture runs
            capture.pool = torch.cuda.graph_pool_handle()
            # no collection inside the capture: an unreachable graph's
            # destructor would make calls a capture forbids
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            self.graph.capture_begin(pool=capture.pool, capture_error_mode=CAPTURE_MODE)
            _local.capture = capture
            try:
                with MONITOR.capturing() as timers:
                    outputs = fn(*self.static_inputs)
            except BaseException as err:
                _local.capture = None
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the failed capture's own report; err says why
                raise RuntimeError(f"capturing {name} as a CUDA graph failed: {err}") from err
            else:
                _local.capture = None
                try:
                    self.graph.capture_end()
                except RuntimeError as err:
                    raise RuntimeError(f"capturing {name} as a CUDA graph failed: {err}") from err
            finally:
                _local.capture = None
                if collecting:
                    gc.enable()
        current.wait_stream(capture_stream)
        self.static_outputs = list(outputs)
        self._per_replay = capture.tallies[0]
        self._loops = [(tally, 0) for _, tally in capture.loops]
        self._trips = capture.trips
        # the monitor's timers of the device spans in the capture
        self._timers = timers
        _graphs.add(self)
        MONITOR.count(f"graph.capture:{name}")

    def __call__(self, inputs) -> list:
        with self._lock:
            with MONITOR.span("graph.inputs"):
                for buffer, value in zip(self.static_inputs, inputs):
                    buffer.copy_(value)
            with MONITOR.span("graph.replay"):
                if self._timers:
                    MONITOR.replaying(self._timers)
                self.graph.replay()
            MONITOR.count(f"graph.replay:{self.name}")
            for counter, name in self._per_replay:
                counter[name] += 1
            with MONITOR.span("graph.outputs"):
                return [t.clone() for t in self.static_outputs]

    def settle(self) -> None:
        """Add the loop bodies' launches since the last settle (reads the
        trip counters: one synchronisation; none without a loop)."""
        if not self._loops:
            return
        with self._lock:
            trips = self._trips[: len(self._loops)].tolist()
            for i, (tally, seen) in enumerate(self._loops):
                if trips[i] != seen:
                    for counter, name in tally:
                        counter[name] += trips[i] - seen
                self._loops[i] = (tally, trips[i])


def settle_launches() -> None:
    """Add every live graph's loop-body launches since the last settle to
    the counters. Call before clearing or reading a launch counter after
    replays."""
    for graph in list(_graphs):
        graph.settle()


class GraphCache:
    """``fn`` (flat device tensors in, a flat sequence of tensors out) as
    a :class:`CapturedGraph` per input signature: shapes, dtypes and
    device, as ``jax.jit`` keys its cache. CPU inputs run ``fn`` eagerly,
    as the caller asked. The monitor's state is part of the key: a graph
    captured with it on holds its device spans' timers, one captured
    with it off holds none."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self.graphs: dict = {}

    @torch.no_grad()
    def __call__(self, *inputs) -> list:
        if inputs[0].device.type != "cuda":
            return list(self.fn(*inputs))
        key = (MONITOR.enabled, *((tuple(t.shape), t.dtype, t.device) for t in inputs))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CapturedGraph(self.fn, inputs, self.name)
        return graph(inputs)
