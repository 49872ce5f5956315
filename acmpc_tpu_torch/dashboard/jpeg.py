"""Baseline JPEG encoder in numpy, for the dashboard's MJPEG feeds.

The JAX package's dashboard encodes with ``cv2.imencode(".jpg", frame,
quality 80)``. This is the port's encoder for the same files: baseline
sequential JPEG (JFIF), 8-bit YCbCr with 4:2:0 chroma (OpenCV's default),
the IJG quantisation tables scaled to ``quality`` as libjpeg scales them,
the standard Huffman tables of ITU-T T.81 Annex K.

Every stage is vectorised over the image: colour conversion and chroma
averaging, the 8x8 DCT as two matrix products over all blocks at once,
quantisation, and the entropy coding, where each block's DC difference,
every non-zero AC coefficient (with the ZRL codes before it) and each
end-of-block code becomes one variable-length code in a flat array, the
codes are put in scan order by one sort, expanded to bits and packed. No
Python loop runs over blocks or coefficients.

    data = encode_jpeg(frame_bgr)        # (H, W, 3) uint8, BGR
"""

from __future__ import annotations

import functools
import struct

import numpy as np

# ITU-T T.81 Annex K.1: quantisation tables in natural (row-major) order
_LUMA_QUANT = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ]
)
_CHROMA_QUANT = np.full(64, 99)
_CHROMA_QUANT.reshape(8, 8)[:4, :4] = [
    [17, 18, 24, 47],
    [18, 21, 26, 66],
    [24, 26, 56, 99],
    [47, 66, 99, 99],
]

# Annex K.3: code counts per length (1-16 bits) and symbols, DC and AC,
# luminance and chrominance
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    bytes.fromhex(
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1 08"
        "23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28"
        "29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58 59"
        "5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89"
        "8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6"
        "b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2"
        "e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9 fa"
    ),
)
_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    bytes.fromhex(
        "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42 91"
        "a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26"
        "27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56 57 58"
        "59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87"
        "88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa b2 b3 b4"
        "b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da"
        "e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9 fa"
    ),
)
_ZRL, _EOB = 0xF0, 0x00


def _zigzag() -> np.ndarray:
    """Natural index of each zig-zag position."""
    cells = sorted(
        ((i, j) for i in range(8) for j in range(8)),
        key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]),
    )
    return np.array([8 * i + j for i, j in cells])


ZIGZAG = _zigzag()


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return (c * np.cos((2 * n + 1) * k * np.pi / 16)).astype(np.float32)


DCT = _dct_matrix()


@functools.lru_cache(maxsize=None)
def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luminance and chrominance tables at ``quality`` (1-100), in
    natural order, as libjpeg's ``jpeg_set_quality`` scales them (baseline:
    each entry in 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(
        np.clip((base * scale + 50) // 100, 1, 255).astype(np.int32)
        for base in (_LUMA_QUANT, _CHROMA_QUANT)
    )


def _huffman_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """The canonical code and its length for each of the 256 symbols
    (length 0 where the table has no such symbol)."""
    counts, symbols = spec
    codes = np.zeros(256, np.uint64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            codes[symbols[k]] = code
            lengths[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


# codes and lengths by [table, symbol]: table 0 luminance, 1 chrominance
_DC_CODES, _DC_LENS = (np.stack(t) for t in zip(*map(_huffman_codes, (_DC_LUMA, _DC_CHROMA))))
_AC_CODES, _AC_LENS = (np.stack(t) for t in zip(*map(_huffman_codes, (_AC_LUMA, _AC_CHROMA))))


# JFIF's RGB to YCbCr, applied to BGR pixels: rows Y, Cb, Cr
_YCC = np.array(
    [
        [0.114, 0.587, 0.299],
        [0.5, -0.331264108, -0.168735892],
        [-0.081312411, -0.418687589, 0.5],
    ],
    np.float32,
)
_YCC_OFFSET = np.array([0.0, 128.0, 128.0], np.float32)


def _to_ycbcr(bgr: np.ndarray) -> list[np.ndarray]:
    """(H, W, 3) BGR uint8 -> the Y, Cb and Cr planes, (H, W) float32."""
    b, g, r = (bgr[..., k].astype(np.float32) for k in range(3))
    return [
        m[0] * b + m[1] * g + m[2] * r + offset
        for m, offset in zip(_YCC, _YCC_OFFSET)
    ]


def _block_rows(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 64), each block's
    pixels in row-major order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(h // 8, w // 8, 64)


@functools.lru_cache(maxsize=None)
def _transform(quality: int, chroma: bool) -> np.ndarray:
    """The (64, 64) matrix that takes a block's 64 level-shifted pixels to
    its DCT coefficients in zig-zag order, each divided by its quantiser:
    the 2-D DCT is DCT (x) DCT on the row-major block."""
    table = quant_tables(quality)[int(chroma)]
    K = np.kron(DCT.astype(np.float64), DCT.astype(np.float64))
    return (K[ZIGZAG] / table[ZIGZAG][:, None]).T.astype(np.float32)


def _quantised(blocks: np.ndarray, quality: int, chroma: bool) -> np.ndarray:
    """Level shift, 2-D DCT and quantisation (rounding half away from
    zero) of (..., 64) blocks; returns int32 coefficients in zig-zag
    order."""
    q = (blocks - 128.0) @ _transform(quality, chroma)
    return np.trunc(q + np.copysign(0.5, q)).astype(np.int32)


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The size category of each value and its extra bits (one's
    complement of |v| for negative values)."""
    a = np.abs(v)
    size = np.zeros(v.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v + (1 << size) - 1, v).astype(np.uint64)
    return size, bits


def _scan_codes(coefs: np.ndarray, comp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every variable-length code of the scan, in order: ``coefs`` (N, 64)
    zig-zag coefficients of the N blocks in scan order with the DC
    differences in ``coefs[:, 0]``, ``comp`` (N,) the component of each
    (0 luminance, 1 and 2 chrominance). Returns (code values, code lengths)."""
    n = len(coefs)
    table = (comp > 0).astype(np.int64)

    # DC: the size's code, then its extra bits
    size, bits = _magnitude(coefs[:, 0])
    dc_len = _DC_LENS[table, size] + size
    dc_val = (_DC_CODES[table, size] << size.astype(np.uint64)) | bits

    # AC: each non-zero coefficient with its run of zeros before it; runs
    # of 16 or more are ZRL codes first, merged into the same code
    blk, pos = np.nonzero(coefs[:, 1:])
    pos = pos + 1
    prev = np.empty_like(pos)
    prev[1:] = pos[:-1]
    first = np.ones(len(pos), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev[first] = 0
    run = pos - prev - 1
    zrl, run = run // 16, run % 16
    t = table[blk]
    size, bits = _magnitude(coefs[blk, pos])
    sym = (run << 4) | size
    sym_len = _AC_LENS[t, sym]
    zrl_len = _AC_LENS[t, _ZRL]
    zrl_code = _AC_CODES[t, _ZRL]
    zrl_val = np.zeros(len(pos), np.uint64)
    for k in (1, 2, 3):  # at most three ZRL codes before a coefficient
        more = zrl >= k
        zrl_val[more] = (zrl_val[more] << zrl_len[more].astype(np.uint64)) | zrl_code[more]
    ac_len = zrl * zrl_len + sym_len + size
    ac_val = (
        ((zrl_val << sym_len.astype(np.uint64)) | _AC_CODES[t, sym]) << size.astype(np.uint64)
    ) | bits

    # EOB after the last non-zero coefficient, where that is before 63
    last = np.zeros(n, np.int64)
    ends = np.nonzero(np.diff(blk, append=-1))[0]  # each block's last non-zero
    last[blk[ends]] = pos[ends]
    eob_blk = np.nonzero(last < 63)[0]
    eob_len = _AC_LENS[table[eob_blk], _EOB]
    eob_val = _AC_CODES[table[eob_blk], _EOB]

    keys = np.concatenate([np.arange(n) * 65, blk * 65 + pos, eob_blk * 65 + 64])
    order = np.argsort(keys, kind="stable")
    values = np.concatenate([dc_val, ac_val, eob_val])[order]
    lengths = np.concatenate([dc_len, ac_len, eob_len])[order]
    return values, lengths


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate the codes' bits (most significant first), pad the last
    byte with ones and stuff a zero byte after every 0xFF. Each code lands
    in one 64-bit word or straddles two; its bits never overlap another
    code's, so the words are sums of the pieces, taken in order."""
    pad = (-int(lengths.sum())) % 8
    values = np.append(values, np.uint64((1 << pad) - 1))
    lengths = np.append(lengths, pad)
    total = int(lengths.sum())
    start = np.cumsum(lengths) - lengths
    word, off = start >> 6, (start & 63).astype(np.uint64)
    n = lengths.astype(np.uint64)
    n0 = np.minimum(n, 64 - off)  # bits in the first word
    n1 = n - n0  # bits in the next
    first = (values >> n1) << (64 - off - n0)
    spill = np.nonzero(n1)[0]
    rest = (values[spill] & ((np.uint64(1) << n1[spill]) - np.uint64(1))) << (64 - n1[spill])
    index = np.concatenate([word, word[spill] + 1])
    pieces = np.concatenate([first, rest])
    order = np.argsort(index, kind="stable")
    index, pieces = index[order], pieces[order]
    heads = np.concatenate([[0], np.nonzero(np.diff(index))[0] + 1])
    words = np.zeros(index[-1] + 1, np.uint64)
    words[index[heads]] = np.add.reduceat(pieces, heads)
    data = np.frombuffer(words.astype(">u8").tobytes(), np.uint8)[: total // 8]
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _headers(height: int, width: int, luma_q: np.ndarray, chroma_q: np.ndarray) -> bytes:
    out = [b"\xff\xd8"]  # SOI
    out.append(_segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    out.append(
        _segment(
            0xFFDB,
            bytes([0]) + luma_q[ZIGZAG].astype(np.uint8).tobytes()
            + bytes([1]) + chroma_q[ZIGZAG].astype(np.uint8).tobytes(),
        )
    )
    # SOF0: 8-bit, three components: Y sampled 2x2 with table 0, Cb and Cr
    # 1x1 with table 1
    out.append(
        _segment(
            0xFFC0,
            struct.pack(">BHHB", 8, height, width, 3)
            + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]),
        )
    )
    dht = b""
    for cls, specs in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA, _AC_CHROMA))):
        for ident, (counts, symbols) in enumerate(specs):
            dht += bytes([(cls << 4) | ident]) + bytes(counts) + bytes(symbols)
    out.append(_segment(0xFFC4, dht))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


def encode_jpeg(image: np.ndarray, quality: int = 80) -> bytes:
    """A baseline JPEG file of an (H, W, 3) uint8 BGR image."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"no JPEG of {width}x{height}")
    luma_q, chroma_q = quant_tables(quality)
    # pad to whole 16x16 MCUs by repeating the last row and column
    ph, pw = -height % 16, -width % 16
    luma, cb, cr = _to_ycbcr(np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge"))
    H, W = luma.shape
    y = _quantised(_block_rows(luma), quality, False)  # (H/8, W/8, 64)
    # 4:2:0: the mean of each 2x2 of Cb and Cr
    cb, cr = (
        _quantised(_block_rows(0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2])), quality, True)
        for c in (cb, cr)
    )  # (H/16, W/16, 64)
    # scan order: per MCU, the four Y blocks in raster order, then Cb, Cr
    my, mx = H // 16, W // 16
    y_mcu = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    mcus = np.concatenate(
        [y_mcu, cb.reshape(my * mx, 1, 64), cr.reshape(my * mx, 1, 64)], axis=1
    )
    # DC differences, each component against its own previous block in
    # scan order (the four Y blocks of an MCU follow one another)
    dc = mcus[..., 0]
    y_dc = dc[:, :4].ravel()
    dc[:, :4] = np.diff(y_dc, prepend=0).reshape(-1, 4)
    dc[:, 4:] = np.diff(dc[:, 4:], axis=0, prepend=0)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    values, lengths = _scan_codes(mcus.reshape(-1, 64), comp)
    return _headers(height, width, luma_q, chroma_q) + _pack(values, lengths) + b"\xff\xd9"
