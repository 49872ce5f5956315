"""Drawing primitives of the dashboard, in numpy on uint8 images.

The JAX package's dashboard draws with OpenCV (``cv2.circle``,
``cv2.drawMarker``, ``cv2.resize``, ``cv2.putText``). This module gives
the port the same primitives at the sizes the renderer calls them, with
OpenCV's pixel rules where they matter:

* ``fill_circles``: OpenCV's 8-connected filled circle (its midpoint
  walk, so radius 1 is a plus of 5 pixels), stamped at many centres at
  once and clipped to the image;
* ``draw_marker``: ``MARKER_CROSS`` and ``MARKER_TRIANGLE_UP``, each line
  a run of pixels, a thick line each pixel stamped with a filled circle
  of half its thickness (OpenCV's round caps);
* ``resize_linear``: bilinear resampling with OpenCV's ``INTER_LINEAR``
  pixel centres (source x = (x + 0.5) * scale - 0.5, edges clamped);
* ``draw_label``: text from a committed 5x8 bitmap font, drawn at twice
  its size (about the height of OpenCV's simplex font at scale 0.7).

Colours are BGR triples, as the JAX renderer's.
"""

from __future__ import annotations

import functools

import numpy as np

# 5x8 bitmap font: eight rows of five bits each (the most significant of
# the five on the left); x-height letters sit on rows 2-6, the baseline
# is under row 6, descenders take row 7. Upper case draws as lower case.
GLYPHS = {
    "a": "00 00 0e 01 0f 11 0f 00",
    "b": "10 10 16 19 11 11 1e 00",
    "c": "00 00 0e 10 10 11 0e 00",
    "d": "01 01 0d 13 11 11 0f 00",
    "e": "00 00 0e 11 1f 10 0e 00",
    "f": "06 09 08 1c 08 08 08 00",
    "g": "00 00 0f 11 11 0f 01 0e",
    "h": "10 10 16 19 11 11 11 00",
    "i": "04 00 0c 04 04 04 0e 00",
    "j": "02 00 06 02 02 02 12 0c",
    "k": "10 10 12 14 18 14 12 00",
    "l": "0c 04 04 04 04 04 0e 00",
    "m": "00 00 1a 15 15 11 11 00",
    "n": "00 00 16 19 11 11 11 00",
    "o": "00 00 0e 11 11 11 0e 00",
    "p": "00 00 1e 11 11 1e 10 10",
    "q": "00 00 0f 11 11 0f 01 01",
    "r": "00 00 16 19 10 10 10 00",
    "s": "00 00 0f 10 0e 01 1e 00",
    "t": "08 08 1c 08 08 09 06 00",
    "u": "00 00 11 11 11 13 0d 00",
    "v": "00 00 11 11 11 0a 04 00",
    "w": "00 00 11 11 15 15 0a 00",
    "x": "00 00 11 0a 04 0a 11 00",
    "y": "00 00 11 11 11 0f 01 0e",
    "z": "00 00 1f 02 04 08 1f 00",
    "0": "0e 11 13 15 19 11 0e 00",
    "1": "04 0c 04 04 04 04 0e 00",
    "2": "0e 11 01 02 04 08 1f 00",
    "3": "1f 02 04 02 01 11 0e 00",
    "4": "02 06 0a 12 1f 02 02 00",
    "5": "1f 10 1e 01 01 11 0e 00",
    "6": "06 08 10 1e 11 11 0e 00",
    "7": "1f 01 02 04 08 08 08 00",
    "8": "0e 11 11 0e 11 11 0e 00",
    "9": "0e 11 11 0f 01 02 0c 00",
    " ": "00 00 00 00 00 00 00 00",
    "_": "00 00 00 00 00 00 00 1f",
    "-": "00 00 00 1f 00 00 00 00",
    ".": "00 00 00 00 00 0c 0c 00",
    ":": "00 0c 0c 00 0c 0c 00 00",
    "/": "00 01 02 04 08 10 00 00",
}
GLYPH_W, GLYPH_H, GLYPH_BASELINE = 5, 8, 7
LABEL_SCALE = 2
LABEL_ADVANCE = (GLYPH_W + 1) * LABEL_SCALE


@functools.lru_cache(maxsize=None)
def circle_offsets(radius: int) -> np.ndarray:
    """(dy, dx) offsets of OpenCV's filled 8-connected circle: the
    horizontal spans its midpoint walk fills."""
    spans: dict[int, int] = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for row, half in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            spans[row] = max(spans.get(row, -1), half)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array(
        [(row, col) for row, half in spans.items() for col in range(-half, half + 1)],
        np.int64,
    )


def fill_circles(img: np.ndarray, centres: np.ndarray, radius: int, colour) -> None:
    """Filled circles of ``radius`` at integer (x, y) ``centres`` (K, 2),
    clipped to the image, in place."""
    centres = np.asarray(centres, np.int64).reshape(-1, 2)
    if len(centres) == 0:
        return
    off = circle_offsets(radius)
    ys = (centres[:, 1, None] + off[None, :, 0]).ravel()
    xs = (centres[:, 0, None] + off[None, :, 1]).ravel()
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[keep], xs[keep]] = colour


def _line_pixels(p0, p1) -> np.ndarray:
    """The (x, y) pixels of the segment p0-p1, one per step of its longer
    axis."""
    (x0, y0), (x1, y1) = p0, p1
    n = max(abs(x1 - x0), abs(y1 - y0))
    t = np.arange(n + 1) / max(n, 1)
    xs = np.floor(x0 + t * (x1 - x0) + 0.5).astype(np.int64)
    ys = np.floor(y0 + t * (y1 - y0) + 0.5).astype(np.int64)
    return np.stack([xs, ys], axis=1)


def draw_line(img: np.ndarray, p0, p1, colour, thickness: int = 1) -> None:
    pts = _line_pixels(p0, p1)
    fill_circles(img, pts, thickness // 2, colour)


MARKER_CROSS, MARKER_TRIANGLE_UP = "cross", "triangle_up"


def draw_marker(img, position, colour, marker: str, size: int, thickness: int = 1) -> None:
    """OpenCV's ``drawMarker`` for the two markers the dashboard uses."""
    x, y = int(position[0]), int(position[1])
    h = size // 2
    if marker == MARKER_CROSS:
        segments = [((x - h, y), (x + h, y)), ((x, y - h), (x, y + h))]
    elif marker == MARKER_TRIANGLE_UP:
        segments = [
            ((x - h, y + h), (x + h, y + h)),
            ((x + h, y + h), (x, y - h)),
            ((x, y - h), (x - h, y + h)),
        ]
    else:
        raise ValueError(f"no marker {marker!r}")
    for p0, p1 in segments:
        draw_line(img, p0, p1, colour, thickness)


def _linear_taps(n_out: int, n_in: int):
    """Source indices and weights of a bilinear resample along one axis,
    OpenCV's INTER_LINEAR pixel centres."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Bilinear resize of an (H, W[, C]) uint8 image to (height, width)."""
    y0, y1, wy = _linear_taps(height, img.shape[0])
    x0, x1, wx = _linear_taps(width, img.shape[1])
    f = img.astype(np.float32)
    rows = f[y0] * (1 - wy)[:, None, None] + f[y1] * wy[:, None, None] if f.ndim == 3 else (
        f[y0] * (1 - wy)[:, None] + f[y1] * wy[:, None]
    )
    wxs = wx[None, :, None] if f.ndim == 3 else wx[None, :]
    out = rows[:, x0] * (1 - wxs) + rows[:, x1] * wxs
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _glyph(ch: str) -> np.ndarray:
    rows = GLYPHS.get(ch.lower())
    if rows is None:
        raise ValueError(f"no glyph for {ch!r}")
    bits = np.array([int(r, 16) for r in rows.split()], np.uint8)
    mask = (bits[:, None] >> np.arange(GLYPH_W - 1, -1, -1)[None, :]) & 1
    return np.kron(mask, np.ones((LABEL_SCALE, LABEL_SCALE), np.uint8)).astype(bool)


def draw_label(img: np.ndarray, text: str, origin, colour) -> None:
    """``text`` with its baseline's left end at ``origin`` (x, y), as
    ``cv2.putText`` places it; clipped to the image, in place."""
    x, y = int(origin[0]), int(origin[1]) - GLYPH_BASELINE * LABEL_SCALE
    for k, ch in enumerate(text):
        mask = _glyph(ch)
        gx = x + k * LABEL_ADVANCE
        ys, xs = np.nonzero(mask)
        ys, xs = ys + y, xs + gx
        keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
        img[ys[keep], xs[keep]] = colour
