"""Connected-run chain scan and the fused track-limit extraction: the
CUDA kernel, the plain versions and the wrapper that picks between them.

``chain_scan`` is ``acmpc_tpu/perception/tracks.py::_chain_scan`` (an
XLA ``lax.scan``, not Pallas) as a loop of PyTorch ops (about 20
launches a row). Over (N, W) boolean rows, bottom-up: seed on the
drivable runs that touch the central third ``[W//3, 2W//3)`` of the
lowest non-empty row, then keep, each row up, the runs that overlap the
previous selection (a seed spreads to its whole run; run ids are the
cumulative count of empty pixels); once started, more than
``gap_tolerance`` consecutive rows with no selection end the chain; an
empty row keeps the previous selection as the next row's seed.

The frame's whole extraction, ``chain_edges``, is one launch of
``csrc/track_chain_edges.cu``: from the (H, W) drivable mask to each
row's leftmost and rightmost selected column (the banding, the chain,
the AND with the full-resolution rows, the fallback to the raw mask and
the row edges of ``acmpc_tpu/perception/tracks.py:62-173``). Its plain
version, :func:`chain_edges_reference`, is the composite of PyTorch ops
around :func:`chain_scan`.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

TRACK_CHAIN_EDGES = "track_chain_edges"
EDGES_SOURCE = "track_chain_edges.cu"
# csrc/track_chain_edges.cu: up to four 64-bit words of a row a lane of
# the walking warp, and the frame's packed rows in a block's opt-in
# shared memory (227 KB, less the static arrays)
EDGES_MAX_WIDTH = 64 * 32 * 4
EDGES_MAX_SMEM = 232448 - 1024


def chain_scan(rows: torch.Tensor, gap_tolerance: int) -> torch.Tensor:
    """The bottom-up connected-run chain of ``rows``, one frame's (N, W),
    bool or uint8 (nonzero is drivable), contiguous, on any device; bool
    of the same shape. The recurrence of ``_chain_scan``, one row per
    loop step (see the module docstring)."""
    if rows.dim() != 2:
        raise ValueError(f"rows must be one frame's (N, W), got {tuple(rows.shape)}")
    if rows.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"rows must be bool or uint8, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
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


# -- the fused extraction: banding, chain, AND, fallback and row edges --


def scan_rows(mask: torch.Tensor, bonnet_row: int, gap_tolerance: int = 3, band: int = 1):
    """What the chain scan gets from a frame: (the usable full-resolution
    mask, the (ceil(H / band), W) contiguous bool rows, the gap in rows of
    the scan). Usable rows lie above ``bonnet_row``; a band row is the OR
    of ``band`` usable rows; the gap rounds to whole bands (Python's
    ``round``: halves to even), at least one."""
    H, W = mask.shape
    usable = (mask > 0) & (torch.arange(H, device=mask.device) < bonnet_row)[:, None]
    if band <= 1:
        # elementwise ops keep a transposed mask's strides
        return usable, usable.contiguous(), gap_tolerance
    hb = -(-H // band)
    padded = usable
    if hb * band > H:
        padded = torch.cat([usable, usable.new_zeros((hb * band - H, W))])
    bands = padded.reshape(hb, band, W).any(dim=1)
    return usable, bands, max(1, round(gap_tolerance / band))


def row_edge_columns(mask: torch.Tensor):
    """Per-row leftmost/rightmost drivable column. mask: (H, W) 0/1.
    Returns (left_cols, right_cols, row_valid); a row with no drivable
    pixel has both columns 0 (the first extreme of a constant row)."""
    w = mask.shape[1]
    ascending = torch.arange(1, w + 1, dtype=torch.int32, device=mask.device)
    weighted = mask.to(torch.int32) * ascending[None, :]
    right = torch.argmax(weighted, dim=1)
    sentinel = torch.where(weighted == 0, w + 1, weighted)
    left = torch.argmin(sentinel, dim=1)
    row_valid = torch.any(mask > 0, dim=1)
    return left, right, row_valid


def chain_edges_reference(
    mask: torch.Tensor,
    bonnet_row: int,
    gap_tolerance: int = 3,
    band: int = 1,
    return_mask: bool = False,
):
    """Plain PyTorch version of :func:`chain_edges`: ``scan_rows``,
    :func:`chain_scan` over the band rows, each band's selection repeated
    over its rows and ANDed with the usable mask, the raw mask if nothing
    was selected, then ``row_edge_columns``."""
    H = mask.shape[0]
    usable, rows, gap = scan_rows(mask, bonnet_row, gap_tolerance, band)
    sel = chain_scan(rows, gap)
    if band > 1:
        sel = sel.repeat_interleave(band, dim=0)[:H]
    sel = sel & usable
    selected = torch.where(sel.any(), sel, mask > 0).to(mask.dtype)
    edges = row_edge_columns(selected)
    return (*edges, selected) if return_mask else edges


def edges_smem_bytes(height: int, width: int, band: int) -> int:
    """Shared memory of one frame in ``csrc/track_chain_edges.cu``: the
    packed rows (a 64-bit word per 64 columns, padded to an odd count),
    the band selections when ``band > 1``, a flag byte a band."""
    words = -(-width // 64) | 1
    n_bands = -(-height // band)
    return 8 * words * height + (8 * words * n_bands if band > 1 else 0) + n_bands


def _edges_arguments(mask: torch.Tensor, gap_tolerance: int, band: int) -> tuple[int, int]:
    """Check a frame for :func:`chain_edges` on any device; returns (the
    band, the gap in band steps). Raises on what the kernel does not take."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be one frame's (H, W), got {tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    H, W = mask.shape
    if H == 0 or W == 0:
        raise ValueError(f"mask is empty: {tuple(mask.shape)}")
    band = max(1, int(band))
    gap = gap_tolerance if band == 1 else max(1, round(gap_tolerance / band))
    if gap < 0:
        raise ValueError(f"gap tolerance must be >= 0, got {gap_tolerance}")
    if W > EDGES_MAX_WIDTH:
        raise ValueError(f"mask wider than {EDGES_MAX_WIDTH} columns: {W}")
    smem = edges_smem_bytes(H, W, band)
    if smem > EDGES_MAX_SMEM:
        raise ValueError(
            f"a {H}x{W} frame at band {band} needs {smem} bytes of shared memory; "
            f"the kernel holds at most {EDGES_MAX_SMEM}"
        )
    return band, int(gap)


@functools.lru_cache(maxsize=None)
def _edges_library(device_index: int, stamps: bool = False) -> ctypes.CDLL:
    """The chain-edges kernel's library; ``stamps`` builds the variant
    that records its stage clocks (``bench/chain_stages.py``)."""
    defines = ("TRACK_CHAIN_EDGES_STAMPS",) if stamps else ()
    lib = build_library(EDGES_SOURCE, torch.device("cuda", device_index), defines)
    lib.track_chain_edges_launch.argtypes = [
        ctypes.c_void_p,  # mask
        ctypes.c_int,  # H
        ctypes.c_int,  # W
        ctypes.c_int,  # bonnet row
        ctypes.c_int,  # band
        ctypes.c_int,  # gap, in band steps
        ctypes.c_void_p,  # left (int64)
        ctypes.c_void_p,  # right (int64)
        ctypes.c_void_p,  # valid (bool)
        ctypes.c_void_p,  # selected mask or null
        ctypes.c_void_p,  # stream
    ]
    lib.track_chain_edges_launch.restype = ctypes.c_int
    return lib


def _launch_edges(mask: torch.Tensor, bonnet_row: int, gap_tolerance: int, band: int, return_mask: bool):
    """Launch the fused kernel on a CUDA tensor and count it in
    ``chain_edges.launches`` (under a capture, at each replay:
    ``graph_loop.count_launch``); anything else raises."""
    band, gap = _edges_arguments(mask, gap_tolerance, band)
    if mask.device.type != "cuda":
        raise ValueError(f"the chain-edges kernel takes a CUDA tensor, not one on {mask.device}")
    mask = mask.contiguous()
    H, W = mask.shape
    device = mask.device
    left = torch.empty(H, dtype=torch.int64, device=device)
    right = torch.empty(H, dtype=torch.int64, device=device)
    valid = torch.empty(H, dtype=torch.bool, device=device)
    selected = torch.empty((H, W), dtype=mask.dtype, device=device) if return_mask else None
    bonnet = min(max(int(bonnet_row), 0), H)
    lib = _edges_library(device.index)
    with torch.cuda.device(device.index):
        stream = torch.cuda.current_stream(device.index).cuda_stream
        err = lib.track_chain_edges_launch(
            mask.data_ptr(), H, W, bonnet, band, gap,
            left.data_ptr(), right.data_ptr(), valid.data_ptr(),
            selected.data_ptr() if return_mask else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"track_chain_edges kernel launch failed: CUDA error {err}")
    count_launch(chain_edges.launches, TRACK_CHAIN_EDGES)
    return (left, right, valid, selected) if return_mask else (left, right, valid)


def chain_edges(
    mask: torch.Tensor,
    bonnet_row: int,
    gap_tolerance: int = 3,
    band: int = 1,
    return_mask: bool = False,
):
    """Each row's (left column, right column, valid) of the drivable run
    chain connected to the vehicle in the (H, W) bool or uint8 ``mask``
    (int64, int64, bool); with ``return_mask``, also the 0/1 selected mask
    in ``mask``'s dtype. See ``chain_edges_reference``. CPU tensors take
    the plain version, CUDA tensors one launch of the fused kernel;
    ``chain_edges.launches`` counts the launches."""
    if mask.device.type == "cpu":
        band, _ = _edges_arguments(mask, gap_tolerance, band)
        return chain_edges_reference(mask, bonnet_row, gap_tolerance, band, return_mask)
    return _launch_edges(mask, bonnet_row, gap_tolerance, band, return_mask)


chain_edges.launches = collections.Counter()
