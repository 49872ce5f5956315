"""SegFormer's head resample (``ops/segformer_resample.py``) on the card:
the inputs the on-card tests and ``chip_smoke.py`` share, the kernel
against its plain version (the share of bit-equal elements, the largest
distance in units in the last place), and its time beside the plain
version's (PyTorch's bilinear resizes and ``torch.cat``, the library
composition the head ran before) and its bound.

    python -m acmpc_tpu_torch.bench.segformer_head [--frame 736 1280] [--batch 1]

Prints one JSON line: for bf16 and float32, the comparison and the ms a
launch at each ``PIXELS_PER_WARP`` tried (CUDA events over 50 launches).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from acmpc_tpu_torch.bench.perception_loop import _time_ms
from acmpc_tpu_torch.ops import segformer_resample as op

STRIDES = (4, 8, 16, 32)  # the four stages' grids against the frame
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published peak
PIXELS_PER_WARP = (1, 2, 4, 8)
REPS = 50


def head_parts(n: int, height: int, width: int, dtype, device, seed: int = 0,
               channels: int = op.CHANNELS) -> list[torch.Tensor]:
    """The head's four projected maps of an (height, width) frame, as
    ``DecodeHead`` makes them: (n, channels, h_i, w_i) views of (n, h_i *
    w_i, channels) tokens, channels last, at a quarter to a 32nd of the
    frame; normal draws from ``seed``, made in float32 on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    parts = []
    for stride in STRIDES:
        h, w = height // stride, width // stride
        tokens = torch.randn(n, h * w, channels, generator=g, device=device).to(dtype)
        parts.append(tokens.unflatten(1, (h, w)).permute(0, 3, 1, 2))
    return parts


def ulp_distance(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each element's distance in units in the last place of the dtype
    (bf16 or float32): the difference of the bit patterns in their order
    (both zeros at 0), int64."""
    bits, top = {torch.bfloat16: (torch.int16, 0x7FFF), torch.float32: (torch.int32, 0x7FFFFFFF)}[got.dtype]

    def ordered(t):
        i = t.view(bits).long()
        return torch.where(i < 0, -(i & top), i)

    return (ordered(got) - ordered(want)).abs()


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The share of bit-equal elements and the largest ulp distance."""
    d = ulp_distance(got, want)
    return {"elements": d.numel(), "bit_equal_share": float((d == 0).double().mean()), "max_ulps": int(d.max())}


def resample_bytes(n: int, height: int, width: int, itemsize: int, channels: int = op.CHANNELS) -> int:
    """The least bytes: the four parts read once, the concatenation
    written once."""
    read = sum((height // s) * (width // s) for s in STRIDES) * channels
    written = (height // 4) * (width // 4) * len(STRIDES) * channels
    return n * itemsize * (read + written)


def measure(n: int, height: int, width: int, dtype, device="cuda", seed: int = 0) -> dict:
    """The kernel against the plain version at one shape: the comparison,
    the kernel's ms at each pixels-a-warp tried (the wrapper's own first),
    the plain version's ms and the bound."""
    parts = head_parts(n, height, width, dtype, device, seed)
    size = parts[0].shape[-2:]
    got = op.segformer_resample(parts, size)
    want = op.segformer_resample_reference(parts, size)
    if got.stride() != want.stride():
        raise RuntimeError(f"strides {got.stride()} against the plain version's {want.stride()}")
    row = {"n": n, "frame": [height, width], "dtype": str(dtype).removeprefix("torch."), **compare(got, want)}
    chosen = op.PIXELS_PER_WARP
    row["pixels_per_warp"] = chosen
    ms = {}
    try:
        for p in (chosen, *(p for p in PIXELS_PER_WARP if p != chosen)):
            op.PIXELS_PER_WARP = p
            ms[p] = _time_ms(lambda: op.segformer_resample(parts, size), REPS, parts[0].device)
    finally:
        op.PIXELS_PER_WARP = chosen
    row["ms"] = ms[chosen]
    row["ms_by_pixels_per_warp"] = ms
    row["plain_ms"] = _time_ms(lambda: op.segformer_resample_reference(parts, size), REPS, parts[0].device)
    row["bytes"] = resample_bytes(n, height, width, parts[0].element_size())
    row["bound_ms"] = 1e3 * row["bytes"] / HBM_BYTES_PER_S
    row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frame", type=int, nargs=2, default=(736, 1280), metavar=("HEIGHT", "WIDTH"))
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("segformer_head needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = [measure(args.batch, *args.frame, dtype) for dtype in (torch.bfloat16, torch.float32)]
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
