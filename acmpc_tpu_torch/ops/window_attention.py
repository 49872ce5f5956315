"""Shifted-window attention with relative position bias (Swin Transformer,
arXiv:2103.14030), the attention core of one Swin block: the CUDA
kernel, its plain version and the wrapper that picks between them.

``window_attention(qkv, bias, table, heads, window, shift)`` takes the
qkv Linear's output of the block's real tokens, (N, H, W, 3C) (q, k and
v, each ``heads`` heads of 32), the Linear's bias (3C), the relative
position bias table ((2 window - 1)^2, heads), and returns the
attention's output (N, H, W, C) at each token's own place, ready for the
proj Linear. It computes what the published ``SwinTransformerBlock``
computes between the qkv and proj Linears: the map padded with zeros to
whole windows (a padded token's q, k and v are the Linear of a zero,
its bias), rolled by ``-shift``, partitioned into windows of ``window``
x ``window``, ``softmax(q k^T / sqrt(32) + B_rel + M_shift) v`` per
window and head (``B_rel`` the table at each pair's relative offset,
``M_shift`` -100 between the regions of the rolled map's last windows
where ``shift`` is not 0), the partition reversed, rolled back and
cropped. Padded tokens are keys and values like any other, unmasked in
unshifted windows, as published.

The published block runs the qkv and proj Linears on the padded
windows; here they run on the real tokens only. That is a departure of
form only: both are maps of one token at a time, and the padded
tokens' outputs are cropped.

CPU tensors go to :func:`window_attention_reference` (the published
composition); CUDA tensors (bf16 or float32, contiguous, heads of 32,
windows up to 12, a shift below the window) to ``csrc/window_attention.cu``,
one launch a call, or the call raises. ``window_attention.launches``
counts the launches by kernel (under a capture, at each replay). The
library is built and loaded at the first launch, so only a model that
runs the op (a Swin backbone) loads it.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

SOURCE = "window_attention.cu"
KERNEL = "window_attention"  # bf16, tensor cores
KERNEL_F32 = "window_attention[f32]"  # float32, CUDA cores
HEAD_DIM = 32  # the kernel's head width (Swin's, every stage)
MAX_WINDOW = 12  # the kernel's largest window (Swin-L's)
MASKED = -100.0  # the published mask between the shifted windows' regions
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def relative_position_index(window: int, device=None) -> torch.Tensor:
    """(window^2, window^2) int64, the published ``relative_position_index``:
    the table's row of query i and key j, ``(r_i - r_j + window - 1) (2
    window - 1) + c_i - c_j + window - 1``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window, device=device), torch.arange(window, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(windows, window^2, window^2) float32, the published ``attn_mask`` of
    the rolled map padded to (hp, wp): 0 between positions of one region,
    -100 between positions of two (regions: rows ``[0, hp - window)``,
    ``[hp - window, hp - shift)``, ``[hp - shift, hp)``, and the same of
    columns)."""
    img = torch.zeros((1, hp, wp, 1), device=device)
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    windows = partition(img, window).view(-1, window * window)
    mask = windows[:, None, :] - windows[:, :, None]
    return mask.masked_fill(mask != 0, MASKED).masked_fill(mask == 0, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """The published ``window_partition``: (N, H, W, C) -> (N * windows,
    window, window, C), windows in row-major order."""
    n, h, w, c = x.shape
    x = x.view(n, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window, window, c)


def reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The published ``window_reverse``: the inverse of :func:`partition`."""
    n = windows.shape[0] // ((h // window) * (w // window))
    x = windows.view(n, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(n, h, w, -1)


def window_attention_reference(qkv, bias, table, heads: int, window: int, shift: int) -> torch.Tensor:
    """The plain version of :func:`window_attention`: the published block's
    composition between its two Linears, in the inputs' dtype (the
    softmax's too, as ``nn.Softmax`` runs it), the padded tokens' q, k
    and v the bias."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    hp, wp = -(-h // window) * window, -(-w // window) * window
    x = bias.expand(n, hp, wp, c3).clone()
    x[:, :h, :w] = qkv
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = partition(x, window).view(-1, window * window, c3)
    b_, tokens, _ = windows.shape
    q, k, v = windows.reshape(b_, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(window, qkv.device)
    attn = attn + table[index.view(-1)].view(tokens, tokens, heads).permute(2, 0, 1)[None]
    if shift:
        mask = shift_mask(hp, wp, window, shift, qkv.device).to(attn.dtype)
        attn = (attn.view(n, -1, heads, tokens, tokens) + mask[None, :, None]).view(b_, heads, tokens, tokens)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b_, tokens, c)
    x = reverse(out.view(-1, window, window, c), window, hp, wp)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x[:, :h, :w].contiguous()


_PTR = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    """The kernel's library for one card."""
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.window_attention_launch.argtypes = [_PTR] * 4 + [ctypes.c_int] * 8 + [_PTR]
    lib.window_attention_launch.restype = ctypes.c_int
    return lib


def _check(qkv, bias, table, heads: int, window: int, shift: int) -> tuple[int, int, int, int]:
    """(N, H, W, C); raises on what the kernel does not take."""
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (N, H, W, 3C), got {tuple(qkv.shape)}")
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    if c != heads * HEAD_DIM:
        raise ValueError(f"the kernel takes heads of {HEAD_DIM}, got {c} channels over {heads} heads")
    if not 1 <= window <= MAX_WINDOW or not 0 <= shift < window:
        raise ValueError(f"the kernel takes windows up to {MAX_WINDOW} and a shift below the window, "
                         f"got {window} and {shift}")
    if tuple(bias.shape) != (c3,) or tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"bias must be ({c3},) and the table {((2 * window - 1) ** 2, heads)}, "
                         f"got {tuple(bias.shape)} and {tuple(table.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv must be bfloat16 or float32, got {qkv.dtype}")
    for name, t in (("qkv", qkv), ("bias", bias), ("table", table)):
        if t.dtype != qkv.dtype:
            raise TypeError(f"{name} is {t.dtype}, qkv {qkv.dtype}")
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("qkv and bias must be 16-byte aligned")
    return n, h, w, c


def window_attention(qkv, bias, table, heads: int, window: int, shift: int) -> torch.Tensor:
    """The attention core of one Swin block (see the module): CPU tensors
    through :func:`window_attention_reference`, CUDA tensors through the
    kernel, one launch; returns (N, H, W, C) in the input's dtype."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, table, heads, window, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention runs on cuda or cpu, not {qkv.device}")
    n, h, w, c = _check(qkv, bias, table, heads, window, shift)
    out = torch.empty((n, h, w, c), dtype=qkv.dtype, device=qkv.device)
    index = qkv.device.index
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        err = _library(index).window_attention_launch(
            qkv.data_ptr(), bias.data_ptr(), table.data_ptr(), out.data_ptr(), _DTYPES[qkv.dtype],
            n, h, w, c, heads, window, shift, stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    count_launch(window_attention.launches, KERNEL if qkv.dtype == torch.bfloat16 else KERNEL_F32)
    return out


window_attention.launches = collections.Counter()
