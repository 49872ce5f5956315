"""SegFormer's head resample: the four stages' projections brought to
stage 1's grid and concatenated, deepest first, into the fuse
convolution's input: the CUDA kernel, its plain version and the wrapper
that picks between them.

``segformer_resample(parts, size)`` takes the head's four projected maps,
shallowest first, as ``DecodeHead`` makes them: (N, C, h_i, w_i) in
``channels_last`` memory. Each part not on ``size`` is resized bilinearly
(``align_corners=False``) to it; the result is the (N, 4C, H, W)
``channels_last`` tensor of ``torch.cat(resized[::-1], dim=1)``: the
deepest part first, as published.

CPU tensors go to :func:`segformer_resample_reference` (that composition:
``F.interpolate`` and ``torch.cat``); CUDA tensors (bf16 or float32, C =
768, channels last) to ``csrc/segformer_resample.cu``, one launch a call,
whose output equals PyTorch's resize bit for bit, or the call raises.
``segformer_resample.launches`` counts the launches (under a capture, at
each replay). The kernel's library is built and loaded at the first
launch, so only a model that runs the op (SegFormer) loads it.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

SOURCE = "segformer_resample.cu"
KERNEL = "segformer_resample"
PARTS = 4
CHANNELS = 768  # the kernel's part width: SegFormer B2-B5's decoder_hidden_size
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
PIXELS_PER_WARP = 2  # a block's 8 warps take 16 neighbouring pixels of a row (the fastest of 1-8 on an H100)


def segformer_resample_reference(parts, size) -> torch.Tensor:
    """The plain version of :func:`segformer_resample`: each part not on
    ``size`` through ``F.interpolate`` (bilinear, ``align_corners=False``),
    then ``torch.cat`` of the four, deepest first."""
    size = tuple(size)
    resized = [p if tuple(p.shape[-2:]) == size
               else F.interpolate(p, size=size, mode="bilinear", align_corners=False) for p in parts]
    return torch.cat(resized[::-1], dim=1)


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The kernel's library for one card."""
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.segformer_resample_launch.argtypes = (
        [_PTR] * PARTS + [ctypes.c_int] * (2 * PARTS) + [_PTR] + [ctypes.c_int] * 5 + [_PTR]
    )
    lib.segformer_resample_launch.restype = ctypes.c_int
    return lib


def _check(parts, size) -> tuple[int, int, int]:
    """(N, H, W); raises on what the kernel does not take."""
    if len(parts) != PARTS:
        raise ValueError(f"the kernel takes {PARTS} parts, got {len(parts)}")
    H, W = (int(s) for s in size)
    first = parts[0]
    if first.dim() != 4:
        raise ValueError(f"parts must be (N, C, h, w), got {tuple(first.shape)}")
    N = first.shape[0]
    if N < 1 or H < 1 or W < 1:
        raise ValueError(f"empty output: N {N}, size {(H, W)}")
    for i, p in enumerate(parts):
        if p.dim() != 4 or p.shape[0] != N or p.shape[1] != CHANNELS or min(p.shape[2:]) < 1:
            raise ValueError(f"part {i} must be ({N}, {CHANNELS}, h, w), got {tuple(p.shape)}")
        if p.dtype not in DTYPES:
            raise TypeError(f"part {i} must be bfloat16 or float32, got {p.dtype}")
        if p.dtype != first.dtype:
            raise TypeError(f"part {i} is {p.dtype}, part 0 {first.dtype}")
        if p.device != first.device:
            raise ValueError(f"part {i} is on {p.device}, part 0 on {first.device}")
        if not p.permute(0, 2, 3, 1).is_contiguous():
            raise ValueError(f"part {i} must be channels_last and dense")
        if p.data_ptr() % 16:
            raise ValueError(f"part {i} must be 16-byte aligned")
    return N, H, W


def segformer_resample(parts, size) -> torch.Tensor:
    """The head's resample and concatenation (see the module): CPU tensors
    through :func:`segformer_resample_reference`, CUDA tensors through the
    kernel, one launch; returns (N, 4C, H, W) in ``channels_last``."""
    first = parts[0]
    if first.device.type == "cpu":
        return segformer_resample_reference(parts, size)
    if first.device.type != "cuda":
        raise ValueError(f"segformer_resample runs on cuda or cpu, not {first.device}")
    N, H, W = _check(parts, size)
    out = torch.empty((N, PARTS * CHANNELS, H, W), dtype=first.dtype, device=first.device,
                      memory_format=torch.channels_last)
    index = first.device.index
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library(index).segformer_resample_launch(
            *(p.data_ptr() for p in parts), *(int(s) for p in parts for s in p.shape[2:]),
            out.data_ptr(), N, H, W, DTYPES[first.dtype], PIXELS_PER_WARP, stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    count_launch(segformer_resample.launches, KERNEL)
    return out


segformer_resample.launches = collections.Counter()
