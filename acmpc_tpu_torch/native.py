"""The map maker's point-cloud tour, in host C++ (``csrc/tsp_tour.cpp``).

Counterpart of ``acmpc_tpu/native/__init__.py``. ``tsp_tour`` builds the
C++ source at first use with the host compiler into
``build/torch_kernels/`` (``ops/cuda_build.build_host_library``) and calls
it through ``ctypes``; a failed build raises. ``_tsp_tour_numpy`` is its
plain twin, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np

from acmpc_tpu_torch.ops.cuda_build import build_host_library

SOURCE = "tsp_tour.cpp"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_host_library(SOURCE)
    lib.acmpc_tsp_tour.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_double,
    ]
    lib.acmpc_tsp_tour.restype = None
    return lib


def tsp_tour(points: np.ndarray, time_bound_s: float = 5.0) -> np.ndarray:
    """Order 2-D points into a closed tour (index array): nearest-neighbour
    construction, then 2-opt for at most ``time_bound_s`` seconds."""
    points = np.ascontiguousarray(points[:, :2], np.float32)
    n = len(points)
    if n <= 2:
        return np.arange(n)
    lib = _library()
    order = np.zeros(n, np.int32)
    lib.acmpc_tsp_tour(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        float(time_bound_s),
    )
    return order.astype(np.int64)


def _tsp_tour_numpy(points: np.ndarray, time_bound_s: float) -> np.ndarray:
    """Pure-numpy NN construction + vectorised 2-opt passes."""
    n = len(points)
    # nearest-neighbour construction
    remaining = np.arange(1, n)
    tour = [0]
    current = 0
    while len(remaining):
        d = np.linalg.norm(points[remaining] - points[current], axis=1)
        k = int(np.argmin(d))
        current = int(remaining[k])
        tour.append(current)
        remaining = np.delete(remaining, k)
    tour = np.asarray(tour)

    t_end = time.monotonic() + time_bound_s
    improved = True
    while improved and time.monotonic() < t_end:
        improved = False
        pts = points[tour]
        nxt = np.roll(pts, -1, axis=0)
        seg = np.linalg.norm(nxt - pts, axis=1)
        for i in range(n - 2):
            # vectorised scan of all j for this i
            j = np.arange(i + 2, n)
            d_new = np.linalg.norm(pts[j] - pts[i], axis=1) + np.linalg.norm(
                pts[(j + 1) % n] - pts[i + 1], axis=1
            )
            d_old = seg[i] + seg[j]
            delta = d_new - d_old
            k = int(np.argmin(delta))
            if delta[k] < -1e-9:
                jj = i + 2 + k
                tour[i + 1 : jj + 1] = tour[i + 1 : jj + 1][::-1]
                improved = True
                break
            if time.monotonic() >= t_end:
                break
    return tour
