"""Where the fused chain-edges kernel's time goes: its stage clocks.

Builds ``csrc/track_chain_edges.cu`` a second time with its stage stamps
(``-DTRACK_CHAIN_EDGES_STAMPS``) and launches it on the perception
benchmark's masks at the camera's size (1280x736, bonnet row 600): the
sim's masks at a few poses and an empty frame (the fallback, which packs
and walks every row), at bands 4 and 1. For each it prints the kernel's
ms (CUDA events over 200 launches of the build without stamps), the band
steps the chain walked, and, in the SM's cycles from the kernel's start:
the first band loaded, the walk's end, the last producer's end and the
edge stage's end (the walk and the packing overlap; the edges start after
both), with the edges alone asked for, as the extractor asks. The stamped
build is checked bit-equal to the plain version.

    python -m acmpc_tpu_torch.bench.chain_stages [--poses 2] [--out f]

Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

from acmpc_tpu_torch.bench import perception_loop as loop
from acmpc_tpu_torch.ops import track_chain as chain

STAGES = ("start", "first_band", "walk_end", "pack_end", "edges_end")
REPS = 200


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def stage_cycles(lib, mask: torch.Tensor, bonnet_row: int, band: int, gap_tolerance: int = 3) -> dict:
    """One launch of the stamped build: its stage clocks, in cycles from
    the start, after checking its outputs against the plain version."""
    band, gap = chain._edges_arguments(mask, gap_tolerance, band)
    H, W = mask.shape
    # the edges alone, as the extractor asks for them
    out = [torch.empty(H, dtype=torch.int64, device=mask.device) for _ in range(2)]
    out.append(torch.empty(H, dtype=torch.bool, device=mask.device))
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = lib.track_chain_edges_launch(
        mask.data_ptr(), H, W, bonnet_row, band, gap, *(t.data_ptr() for t in out), None, stream
    )
    if err != 0:
        raise RuntimeError(f"stamped track_chain_edges launch failed: CUDA error {err}")
    torch.cuda.synchronize(mask.device)
    want = chain.chain_edges_reference(mask, bonnet_row, gap_tolerance, band)
    if not all(torch.equal(g, w) for g, w in zip(out, want)):
        raise RuntimeError("the stamped kernel disagrees with the plain version")
    stamps = (ctypes.c_ulonglong * len(STAGES))()
    err = lib.track_chain_edges_read_stamps(stamps)
    if err != 0:
        raise RuntimeError(f"reading the stage stamps failed: CUDA error {err}")
    return {name: int(stamps[i]) - int(stamps[0]) for i, name in enumerate(STAGES) if i > 0}


def kernel_ms(mask: torch.Tensor, bonnet_row: int, band: int) -> float:
    chain._launch_edges(mask, bonnet_row, 3, band, False)
    torch.cuda.synchronize(mask.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        chain._launch_edges(mask, bonnet_row, 3, band, False)
    end.record()
    torch.cuda.synchronize(mask.device)
    return start.elapsed_time(end) / REPS


def bands_walked(mask: torch.Tensor, bonnet_row: int, band: int, gap_tolerance: int = 3) -> int:
    """Band steps the kernel's chain takes: from the band holding the last
    usable row down to band 0, or to the band where the chain dies."""
    _, rows, gap = chain.scan_rows(mask, bonnet_row, gap_tolerance, band)
    has = chain.chain_scan(rows, gap).any(dim=1).tolist()
    top = -(-min(bonnet_row, mask.shape[0]) // band) - 1
    started, miss, walked = False, 0, 0
    for k in range(top, -1, -1):
        walked += 1
        started = started or has[k]
        miss = 0 if has[k] else miss + started
        if miss > gap:
            break
    return walked


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--poses", type=int, default=2)
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_stages: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    lib = chain._edges_library(device.index, stamps=True)
    lib.track_chain_edges_read_stamps.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.track_chain_edges_read_stamps.restype = ctypes.c_int

    cfg = loop.perception_config()
    centre, left, right, _ = loop.circuit()
    sim = loop.make_sim(cfg, centre, left, right)
    masks = {f"sim{k}": m for k, m in enumerate(loop.sim_masks(sim, centre, args.poses))}
    masks["empty"] = masks["sim0"] * 0
    bonnet = cfg.n_rows_to_remove_bonnet
    rows = []
    for name, mask_np in masks.items():
        mask = torch.as_tensor(mask_np, device=device)
        for band in (4, 1):
            rows.append({
                "mask": name,
                "band": band,
                "ms": kernel_ms(mask, bonnet, band),
                "bands_walked": bands_walked(mask, bonnet, band),
                "cycles": stage_cycles(lib, mask, bonnet, band),
            })
    line = json.dumps({
        "card": _smi("name,power.limit"),
        "sm_clock_mhz": _smi("clocks.sm"),
        "resolution": f"{cfg.image_width}x{cfg.image_height}",
        "bonnet_row": bonnet,
        "rows": rows,
    })
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
