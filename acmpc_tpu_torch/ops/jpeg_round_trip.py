"""The camera frame's JPEG round trip on the card: the CUDA kernels, their
plain version and the wrapper that picks between them.

``jpeg_round_trip(frame)`` returns what
``cv2.imdecode(cv2.imencode(".jpg", frame), cv2.IMREAD_COLOR)`` returns
at OpenCV's defaults (libjpeg, quality 95, 4:2:0 chroma, the integer
"slow" DCT both ways, fancy upsampling), byte for byte, for an (H, W, 3)
uint8 frame whose channel 0 is blue and channel 2 red. The Huffman
coding between the encoder and the decoder is lossless and changes no
pixel, so it is left out; every other step is libjpeg's integer
arithmetic:

1. ``rgb_ycc_convert`` (jccolor.c): 16 fraction bits, Y rounded by
   ``ONE_HALF``, Cb and Cr by ``ONE_HALF - 1``;
2. ``h2v2_downsample`` (jcsample.c): each 2x2 chroma sum plus a bias of
   1 and 2 by turns along the row, shifted down by 2;
3. ``jpeg_fdct_islow`` (jfdctint.c) on each 8x8 block less 128, then
   quantisation (jcdctmgr.c): ``|c| / (8 q)`` rounded half up, the sign
   kept;
4. dequantisation and ``jpeg_idct_islow`` (jidctint.c), with its range
   limit of the masked index (jdmaster.c's ``sample_range_limit``);
5. ``h2v2_fancy_upsample`` (jdsample.c): 3:1 weights in both directions,
   biases 8 and 7, each edge sample repeated; ``h2v2_upsample`` (each
   sample to a 2x2 square) where the chroma is 2 samples wide or less;
6. ``ycc_rgb_convert`` (jdcolor.c) and its tables.

The edges, as libjpeg pads them (jcprepct.c, jcsample.c): the frame's
last column is repeated to a whole number of blocks of each plane (16
columns for the chroma, before it is averaged down); its last row is
repeated to an even count, the chroma averaged down, and the averaged
chroma's last row (row ceil(H/2) - 1) repeated to whole blocks. The
decoder's upsampling reads the chroma of ceil(H/2) x ceil(W/2) samples
and repeats its last row and column.

No TPU kernel is replaced: the JAX package, like the stack it was
modelled on, runs the round trip on the host with OpenCV, so that the
segmenter sees the JPEG-degraded pixels it was trained on. On the card
the frame stays raw until it is uploaded, and the round trip is two
launches of ``csrc/jpeg_round_trip.cu`` in the perception graph. Its
bound is memory: the frame read once and written once (2 x 3 H W bytes,
5.65 MB at 1280x736, 1.7 us at 3.35 TB/s); its integer work is about
1e8 operations.

- ``jpeg_round_trip_blocks`` (a CTA a strip of 4 MCUs, 16 x 64 pixels,
  192 threads): the strip is read once, with 16-byte loads where it lies
  inside the frame, into shared memory; the colour conversion and the
  chroma averaging fill 24 blocks; a thread takes a row of one block for
  the DCT's row pass, then that block's column for the column pass, the
  quantisation, the dequantisation and the inverse DCT's column pass
  (with no exchange between them), then a row again. The decoded Y and
  the decoded 4:2:0 chroma go to a scratch (1.4 MB at 1280x736) that
  stays in L2.
- ``jpeg_round_trip_colour``: a thread a run of 4 pixels of a row reads
  its Y and the chroma it interpolates from, and writes the 12 bytes of
  BGR, as three 4-byte stores where the row allows.

:func:`jpeg_round_trip_reference` is the same arithmetic in integer
PyTorch operations, vectorised over all blocks (``dtype`` int32 as the
kernels compute, or int64). CPU tensors take it; CUDA tensors take the
kernels, and a refused launch raises. ``jpeg_round_trip.launches``
counts the launches (``graph_loop.count_launch``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from acmpc_tpu_torch.dashboard.jpeg import quant_tables
from acmpc_tpu_torch.ops.cuda_build import build_library
from acmpc_tpu_torch.ops.graph_loop import count_launch

SOURCE = "jpeg_round_trip.cu"
BLOCKS_KERNEL = "jpeg_round_trip_blocks"
COLOUR_KERNEL = "jpeg_round_trip_colour"
# cv2.imencode's IMWRITE_JPEG_QUALITY when none is given
QUALITY = 95

# jccolor.c and jdcolor.c: 16 fraction bits
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


# jfdctint.c and jidctint.c: CONST_BITS = 13
_CONST_BITS, _PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def padded_shape(height: int, width: int) -> tuple[int, int]:
    """The luma plane's rows and columns in whole MCUs (16 x 16)."""
    return -(-height // 16) * 16, -(-width // 16) * 16


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _rgb_to_ycc(frame: torch.Tensor, dtype: torch.dtype):
    b, g, r = (c.to(dtype) for c in frame.unbind(-1))
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b + _ONE_HALF) >> _SCALEBITS
    bias = _CBCR_OFFSET + _ONE_HALF - 1
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + bias) >> _SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + bias) >> _SCALEBITS
    return y, cb, cr


def _edge_index(n: int, last: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).clamp_(max=last)


def _downsample(c: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The (H, W) chroma as libjpeg's encoder gives it to the DCT: the
    last column repeated to ``wp`` and the last row to an even count,
    averaged 2x2 (bias 1, 2 by turns), the last averaged row repeated to
    ``hp // 2``."""
    h, w = c.shape
    he = h + h % 2
    c = c[_edge_index(he, h - 1, c.device)][:, _edge_index(wp, w - 1, c.device)]
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + torch.arange(wp // 2, device=c.device, dtype=c.dtype) % 2
    s = (s + bias) >> 2
    return s[_edge_index(hp // 2, he // 2 - 1, c.device)]


def _fdct_pass(x, first: bool):
    """One pass of ``jpeg_fdct_islow`` over 8 tensors (the samples of a
    row, or the row-pass outputs of a column): returns the 8 outputs."""
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    if first:
        o0, o4 = (t10 + t11) * (1 << _PASS1_BITS), (t10 - t11) * (1 << _PASS1_BITS)
        n = _CONST_BITS - _PASS1_BITS
    else:
        o0, o4 = _descale(t10 + t11, _PASS1_BITS), _descale(t10 - t11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (t12 + t13) * F0541
    o2 = _descale(z1 + t13 * F0765, n)
    o6 = _descale(z1 - t12 * F1847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F1175
    t4, t5, t6, t7 = t4 * F0298, t5 * F2053, t6 * F3072, t7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    o7 = _descale(t4 + z1 + z3, n)
    o5 = _descale(t5 + z2 + z4, n)
    o3 = _descale(t6 + z2 + z3, n)
    o1 = _descale(t7 + z1 + z4, n)
    return [o0, o1, o2, o3, o4, o5, o6, o7]


def _idct_pass(x, n: int):
    """One pass of ``jpeg_idct_islow`` over 8 tensors (a column of
    dequantised coefficients, or a row of the first pass's outputs),
    descaled by ``n`` bits: returns the 8 outputs."""
    z1 = (x[2] + x[6]) * F0541
    t2 = z1 - x[6] * F1847
    t3 = z1 + x[2] * F0765
    t0 = (x[0] + x[4]) * (1 << _CONST_BITS)
    t1 = (x[0] - x[4]) * (1 << _CONST_BITS)
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [
        _descale(t10 + t3, n), _descale(t11 + t2, n), _descale(t12 + t1, n), _descale(t13 + t0, n),
        _descale(t13 - t0, n), _descale(t12 - t1, n), _descale(t11 - t2, n), _descale(t10 - t3, n),
    ]


def _range_limit(v: torch.Tensor) -> torch.Tensor:
    """jdmaster.c's post-IDCT table at ``v & 1023``: v + 128 clamped to
    0..255 for |v| < 512, and its wrap beyond."""
    i = v & 1023
    return torch.where(i < 128, i + 128, torch.where(i < 512, 255, torch.where(i < 896, 0, i - 896)))


def _round_trip_blocks(plane: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Each 8x8 block of the (h, w) plane through the forward DCT,
    quantisation by the natural-order table ``q``, dequantisation and
    the inverse DCT: the decoded samples, 0..255."""
    h, w = plane.shape
    blocks = (plane - 128).reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)  # (by, bx, i, j)
    coef = torch.stack(_fdct_pass(blocks.unbind(-1), True), -1)  # (.., i, u)
    coef = torch.stack(_fdct_pass(coef.unbind(-2), False), -2)  # (.., v, u)
    q = q.reshape(8, 8)
    half = 4 * q
    level = torch.sign(coef) * ((coef.abs() + half) // (8 * q))
    coef = level * q
    ws = torch.stack(_idct_pass(coef.unbind(-2), _CONST_BITS - _PASS1_BITS), -2)  # (.., i, u)
    out = torch.stack(_idct_pass(ws.unbind(-1), _CONST_BITS + _PASS1_BITS + 3), -1)  # (.., i, j)
    return _range_limit(out).permute(0, 2, 1, 3).reshape(h, w)


def _upsample(c: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The decoded (hp/2, wp/2) chroma to (height, width) as libjpeg's
    decoder upsamples ceil(height/2) x ceil(width/2) samples of it."""
    dh, dw = -(-height // 2), -(-width // 2)
    device = c.device
    r = torch.arange(height, device=device)
    i = r // 2
    if dw <= 2:  # h2v2_upsample
        j = torch.arange(width, device=device) // 2
        return c[i][:, j]
    far = (i + torch.where(r % 2 == 0, -1, 1)).clamp_(0, dh - 1)
    cs = 3 * c[i, :dw] + c[far, :dw]  # (height, dw) column sums
    j = torch.arange(dw, device=device)
    prev = cs[:, (j - 1).clamp_(min=0)]
    nxt = cs[:, (j + 1).clamp_(max=dw - 1)]
    even = (3 * cs + prev + 8) >> 4
    odd = (3 * cs + nxt + 7) >> 4
    return torch.stack([even, odd], -1).reshape(height, 2 * dw)[:, :width]


def _ycc_to_bgr(y, cb, cr) -> torch.Tensor:
    x_b, x_r = cb - 128, cr - 128
    red = y + ((_fix16(1.402) * x_r + _ONE_HALF) >> _SCALEBITS)
    green = y + ((-_fix16(0.34414) * x_b + _ONE_HALF - _fix16(0.71414) * x_r) >> _SCALEBITS)
    blue = y + ((_fix16(1.772) * x_b + _ONE_HALF) >> _SCALEBITS)
    return torch.stack([blue, green, red], -1).clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def quantisation(quality: int = QUALITY) -> np.ndarray:
    """The (2, 64) int32 luminance and chrominance tables at ``quality``,
    natural order, as libjpeg scales them."""
    return np.stack(quant_tables(quality)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _host_tables() -> ctypes.Array:
    """The tables as the launch takes them (it copies them into the
    kernel's arguments)."""
    return (ctypes.c_int * 128)(*quantisation().ravel().tolist())


def _check(frame: torch.Tensor):
    if frame.dim() != 3 or frame.shape[-1] != 3:
        raise ValueError(f"frame must be (H, W, 3), got {tuple(frame.shape)}")
    if frame.dtype != torch.uint8:
        raise TypeError(f"frame must be uint8, got {frame.dtype}")
    if frame.shape[0] == 0 or frame.shape[1] == 0:
        raise ValueError(f"frame is empty: {tuple(frame.shape)}")


def jpeg_round_trip_reference(frame: torch.Tensor, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plain PyTorch version of :func:`jpeg_round_trip`: libjpeg's integer
    arithmetic on every block at once, in ``dtype`` (int32 or int64)."""
    _check(frame)
    h, w = frame.shape[:2]
    hp, wp = padded_shape(h, w)
    q = torch.as_tensor(quantisation(), dtype=dtype, device=frame.device)
    y, cb, cr = _rgb_to_ycc(frame, dtype)
    y = y[_edge_index(hp, h - 1, y.device)][:, _edge_index(wp, w - 1, y.device)]
    y = _round_trip_blocks(y, q[0])[:h, :w]
    chroma = [_upsample(_round_trip_blocks(_downsample(c, hp, wp), q[1]), h, w) for c in (cb, cr)]
    return _ycc_to_bgr(y, *chroma)


@functools.lru_cache(maxsize=None)
def _library(device_index: int) -> ctypes.CDLL:
    lib = build_library(SOURCE, torch.device("cuda", device_index))
    lib.jpeg_round_trip_launch.argtypes = [
        ctypes.c_void_p,  # frame (H, W, 3) uint8
        ctypes.c_void_p,  # out (H, W, 3) uint8
        ctypes.c_void_p,  # scratch: Y (hp, wp), Cb, Cr (hp/2, wp/2) uint8
        ctypes.c_int,  # H
        ctypes.c_int,  # W
        ctypes.POINTER(ctypes.c_int),  # the (2, 64) quantisation tables, host
        ctypes.c_void_p,  # stream
    ]
    lib.jpeg_round_trip_launch.restype = ctypes.c_int
    return lib


def _launch(frame: torch.Tensor) -> torch.Tensor:
    """Launch both kernels on a CUDA frame and count them in
    ``jpeg_round_trip.launches``; anything else raises."""
    _check(frame)
    if frame.device.type != "cuda":
        raise ValueError(f"the JPEG round-trip kernels take a CUDA tensor, not one on {frame.device}")
    frame = frame.contiguous()
    h, w = frame.shape[:2]
    hp, wp = padded_shape(h, w)
    device = frame.device
    out = torch.empty_like(frame)
    scratch = torch.empty(hp * wp + hp * wp // 2, dtype=torch.uint8, device=device)
    lib = _library(device.index)
    with torch.cuda.device(device.index):
        stream = torch.cuda.current_stream(device.index).cuda_stream
        err = lib.jpeg_round_trip_launch(
            frame.data_ptr(), out.data_ptr(), scratch.data_ptr(), h, w, _host_tables(), stream
        )
    if err != 0:
        raise RuntimeError(f"jpeg_round_trip kernel launch failed: CUDA error {err}")
    count_launch(jpeg_round_trip.launches, BLOCKS_KERNEL)
    count_launch(jpeg_round_trip.launches, COLOUR_KERNEL)
    return out


def jpeg_round_trip(frame: torch.Tensor) -> torch.Tensor:
    """The (H, W, 3) uint8 BGR frame after OpenCV's default JPEG encode
    and decode; see the module docstring. CPU tensors take the plain
    version, CUDA tensors two launches of the kernels;
    ``jpeg_round_trip.launches`` counts the launches."""
    if frame.device.type == "cpu":
        return jpeg_round_trip_reference(frame)
    return _launch(frame)


jpeg_round_trip.launches = collections.Counter()
