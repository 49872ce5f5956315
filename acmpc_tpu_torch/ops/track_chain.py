"""Connected-run chain scan: the CUDA kernel, its plain version and the
wrapper that picks between them.

Replaces ``acmpc_tpu/perception/tracks.py::_chain_scan`` (an XLA
``lax.scan``, not Pallas). Over (N, W) boolean rows, bottom-up: seed on
the drivable runs that touch the central third ``[W//3, 2W//3)`` of the
lowest non-empty row, then keep, each row up, the runs that overlap the
previous selection (a seed spreads to its whole run; run ids are the
cumulative count of empty pixels); once started, more than
``gap_tolerance`` consecutive rows with no selection end the chain; an
empty row keeps the previous selection as the next row's seed.

``rows`` is one frame's (N, W), bool or uint8 (nonzero is drivable),
contiguous; the result is bool of the same shape. CPU tensors go to
:func:`chain_scan_reference`, the same recurrence as a loop of PyTorch
ops (about 20 launches a row); CUDA tensors go to
``csrc/track_chain.cu``, one launch of one CTA for the whole chain, and
a refused launch raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library

TRACK_CHAIN_SCAN = "track_chain_scan"
SOURCE = "track_chain.cu"
# the kernel's block and the columns one thread holds (csrc/track_chain.cu)
THREADS = 256
MAX_WIDTH = 32 * THREADS


def chain_scan_reference(rows: torch.Tensor, gap_tolerance: int) -> torch.Tensor:
    """Plain PyTorch version: the recurrence of ``_chain_scan`` over the
    (N, W) rows, one row per loop step."""
    rows = rows != 0
    n, w = rows.shape
    device = rows.device
    central = torch.zeros(w, dtype=torch.bool, device=device)
    central[w // 3 : 2 * w // 3] = True
    prev = torch.zeros(w, dtype=torch.bool, device=device)
    started = torch.zeros((), dtype=torch.bool, device=device)
    dead = torch.zeros((), dtype=torch.bool, device=device)
    miss = torch.zeros((), dtype=torch.int32, device=device)
    out = torch.empty_like(rows)
    for r in range(n - 1, -1, -1):
        row = rows[r]
        run_id = torch.cumsum(~row, dim=-1)
        seeds = torch.where(started, row & prev, row & central)
        # segment max of the seeds over the run ids
        run_max = torch.zeros(w + 1, dtype=torch.int32, device=device)
        run_max = run_max.scatter_reduce(-1, run_id, seeds.int(), "amax")
        sel = row & (torch.gather(run_max, -1, run_id) > 0) & ~dead
        has = sel.any()
        started_n = started | has
        miss = torch.where(
            has | ~started_n, torch.where(has, torch.zeros_like(miss), miss), miss + 1
        )
        dead = dead | (miss > gap_tolerance)
        prev = torch.where(has, sel, prev)
        started = started_n
        out[r] = sel
    return out


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.track_chain_scan_launch.argtypes = [
        ctypes.c_void_p,  # rows
        ctypes.c_void_p,  # out
        ctypes.c_int,  # N
        ctypes.c_int,  # W
        ctypes.c_int,  # gap
        ctypes.c_void_p,  # stream
    ]
    lib.track_chain_scan_launch.restype = ctypes.c_int
    return lib


def _check(rows: torch.Tensor):
    if rows.dim() != 2:
        raise ValueError(f"rows must be one frame's (N, W), got {tuple(rows.shape)}")
    if rows.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"rows must be bool or uint8, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.shape[-1] > MAX_WIDTH:
        raise ValueError(f"rows wider than {MAX_WIDTH} columns: {rows.shape[-1]}")


def _launch(rows: torch.Tensor, gap_tolerance: int) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor and count it in
    ``chain_scan.launches``; anything else raises."""
    _check(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"the chain-scan kernel takes a CUDA tensor, not one on {rows.device}")
    out = torch.empty(rows.shape, dtype=torch.bool, device=rows.device)
    n, w = rows.shape
    index = rows.device.index
    lib = _library(index)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = lib.track_chain_scan_launch(
            rows.data_ptr(), out.data_ptr(), n, w, int(gap_tolerance), stream
        )
    if err != 0:
        raise RuntimeError(f"track_chain_scan kernel launch failed: CUDA error {err}")
    chain_scan.launches[TRACK_CHAIN_SCAN] += 1
    return out


def chain_scan(rows: torch.Tensor, gap_tolerance: int) -> torch.Tensor:
    """The bottom-up connected-run chain of ``rows``; see the module
    docstring. ``chain_scan.launches`` counts kernel launches."""
    if rows.device.type == "cpu":
        _check(rows)
        return chain_scan_reference(rows, gap_tolerance)
    return _launch(rows, gap_tolerance)


chain_scan.launches = collections.Counter()
