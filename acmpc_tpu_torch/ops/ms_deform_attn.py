"""Multi-scale deformable attention's sampling (Deformable DETR,
arXiv:2010.04159), as Mask2Former's pixel-decoder encoder runs it: the
CUDA kernel, its plain version and the wrapper that picks between them.

``ms_deform_attn(value, offsets, logits, shapes)`` takes the layer's
three linears' outputs as they are: the value projection (N, S, M * D),
the sampling offsets (N, S, M * L * P * 2) and the attention logits
(N, S, M * L * P), over the S tokens of L levels of ``shapes`` ((H_l,
W_l), concatenated in that order). The queries are the tokens
themselves: query q's reference point is its own normalised pixel
centre. Per head and point, in float32: the sampling location ``ref +
offset / (W_l, H_l)``, the softmax over the head's L * P logits, and
the bilinear sample of level l's value at the location (zero padding,
corners not aligned, as ``F.grid_sample`` and the published CUDA
kernel); the output (N, S, M * D) is the weighted sum, in the value's
dtype.

CPU tensors go to :func:`ms_deform_attn_reference` (any number of
levels); CUDA tensors (bf16, contiguous, three levels of four points)
to ``csrc/ms_deform_attn.cu``, one launch a call, or the call raises.
``ms_deform_attn.launches`` counts the launches (under a capture, at
each replay). The kernel's library is built and loaded at the first
launch, so only a model that runs the op (Mask2Former) loads it.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

SOURCE = "ms_deform_attn.cu"
KERNEL = "ms_deform_attn"
LEVELS = 3  # the kernel's levels and points (Mask2Former's, and Deformable DETR's)
POINTS = 4
CHUNK = 8  # channels a CUDA thread: the head's width is a multiple of it


def reference_points(shapes, device) -> torch.Tensor:
    """(S, 2) float32: each token's normalised pixel centre (x, y) on its
    own level, as the published ``get_reference_points`` gives them with
    every valid ratio 1: ``linspace(0.5, W - 0.5, W) / W``."""
    rows = []
    for h, w in shapes:
        y, x = torch.meshgrid(
            torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=device),
            torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=device),
            indexing="ij",
        )
        rows.append(torch.stack((x.reshape(-1) / w, y.reshape(-1) / h), dim=-1))
    return torch.cat(rows)


def sampling_locations(offsets: torch.Tensor, shapes) -> torch.Tensor:
    """(N, S, M, L, P, 2) float32 locations from the offsets (N, S, M, L,
    P, 2): ``ref + offset / (W_l, H_l)``, in float32 whatever the offsets'
    dtype, as the published ``MSDeformAttn.forward`` forms them (each
    level's sizes as scalars: no host copy, so a capture may hold it)."""
    ref = reference_points(shapes, offsets.device)
    off = offsets.float()
    scaled = torch.stack([torch.stack((off[:, :, :, l, :, 0] / w, off[:, :, :, l, :, 1] / h), dim=-1)
                          for l, (h, w) in enumerate(shapes)], dim=3)
    return ref[None, :, None, None, None, :] + scaled


def sample(value: torch.Tensor, shapes, locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain core: (N, S_v, M, D) values, (N, Q, M, L, P, 2) locations
    and (N, Q, M, L, P) weights -> (N, Q, M, D) float32, each point's
    bilinear sample (the published CUDA kernel's four taps: ``w_im = x *
    W - 0.5``, zero outside the level) times its weight, summed level by
    level and point by point in order, in float32."""
    N, _, M, D = value.shape
    Q = locations.shape[1]
    out = torch.zeros((N, Q, M, D), dtype=torch.float32, device=value.device)
    start = 0
    for l, (H, W) in enumerate(shapes):
        v = value[:, start:start + H * W].float()
        start += H * W
        for p in range(locations.shape[4]):
            w_im = locations[:, :, :, l, p, 0] * W - 0.5
            h_im = locations[:, :, :, l, p, 1] * H - 0.5
            inside = (h_im > -1) & (w_im > -1) & (h_im < H) & (w_im < W)
            hl, wl = torch.floor(h_im), torch.floor(w_im)
            lh, lw = h_im - hl, w_im - wl
            hh, hw = 1 - lh, 1 - lw
            y0, x0 = hl.long(), wl.long()
            val = torch.zeros((N, Q, M, D), dtype=torch.float32, device=value.device)
            for dy, dx, wt in ((0, 0, hh * hw), (0, 1, hh * lw), (1, 0, lh * hw), (1, 1, lh * lw)):
                y, x = y0 + dy, x0 + dx
                ok = inside & (y >= 0) & (y <= H - 1) & (x >= 0) & (x <= W - 1)
                idx = torch.where(ok, y * W + x, 0)
                tap = torch.gather(v, 1, idx[..., None].expand(N, Q, M, D))
                val = val + torch.where(ok, wt, 0.0)[..., None] * tap
            out = out + weights[:, :, :, l, p, None].float() * val
    return out


def ms_deform_attn_reference(value, offsets, logits, shapes) -> torch.Tensor:
    """The plain version of :func:`ms_deform_attn`: the locations
    (:func:`sampling_locations`), the softmax in float32 and the sampling
    (:func:`sample`), the output in the value's dtype."""
    N, S, MD = value.shape
    L = len(shapes)
    M = logits.shape[-1] // (L * POINTS)
    loc = sampling_locations(offsets.view(N, S, M, L, POINTS, 2), shapes)
    weights = torch.softmax(logits.view(N, S, M, L * POINTS).float(), dim=-1).view(N, S, M, L, POINTS)
    out = sample(value.view(N, S, M, MD // M), shapes, loc, weights)
    return out.reshape(N, S, MD).to(value.dtype)


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The kernel's library for one card."""
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.ms_deform_attn_launch.argtypes = [_PTR] * 4 + [ctypes.c_int] * (4 + 2 * LEVELS) + [_PTR]
    lib.ms_deform_attn_launch.restype = ctypes.c_int
    return lib


def _check(value, offsets, logits, shapes) -> tuple[int, int, int, int]:
    """(N, S, M, D); raises on what the kernel does not take."""
    if value.dim() != 3 or offsets.dim() != 3 or logits.dim() != 3:
        raise ValueError("value, offsets and logits must be (N, S, channels)")
    N, S, MD = value.shape
    L = len(shapes)
    if L != LEVELS:
        raise ValueError(f"the kernel takes {LEVELS} levels, got {L}")
    if sum(h * w for h, w in shapes) != S:
        raise ValueError(f"the levels {list(shapes)} do not hold the {S} tokens")
    if logits.shape[:2] != (N, S) or logits.shape[-1] % (L * POINTS):
        raise ValueError(f"logits must be (N, S, M * {L * POINTS}), got {tuple(logits.shape)}")
    M = logits.shape[-1] // (L * POINTS)
    if MD % M or (MD // M) % CHUNK:
        raise ValueError(f"the heads' width must be a multiple of {CHUNK}, got {MD} over {M} heads")
    if tuple(offsets.shape) != (N, S, M * L * POINTS * 2):
        raise ValueError(f"offsets must be {(N, S, M * L * POINTS * 2)}, got {tuple(offsets.shape)}")
    for name, t in (("value", value), ("offsets", offsets), ("logits", logits)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if value.data_ptr() % 16:
        raise ValueError("value must be 16-byte aligned")
    return N, S, M, MD // M


def ms_deform_attn(value, offsets, logits, shapes) -> torch.Tensor:
    """The sampling of one deformable layer (see the module): CPU tensors
    through :func:`ms_deform_attn_reference`, CUDA tensors through the
    kernel, one launch; returns (N, S, M * D) in the value's dtype."""
    shapes = [(int(h), int(w)) for h, w in shapes]
    if value.device.type == "cpu":
        return ms_deform_attn_reference(value, offsets, logits, shapes)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn runs on cuda or cpu, not {value.device}")
    N, S, M, D = _check(value, offsets, logits, shapes)
    out = torch.empty_like(value)
    index = value.device.index
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library(index).ms_deform_attn_launch(
            value.data_ptr(), offsets.data_ptr(), logits.data_ptr(), out.data_ptr(),
            N, S, M, D, *(v for hw in shapes for v in hw), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    count_launch(ms_deform_attn.launches, KERNEL)
    return out


ms_deform_attn.launches = collections.Counter()
