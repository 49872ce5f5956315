"""The FPN's Flax initialisation, drawn with numpy.

``FPNResNet18.init(PRNGKey(seed), x)`` in the JAX package draws every
convolution kernel with Flax's default ``lecun_normal`` from a key that
Flax derives per parameter, and sets every other leaf to a constant.
This module computes the same draws without JAX, so that the port's
trainer starts where the JAX tool starts:

- the key: ``PRNGKey(seed)`` is the pair (seed >> 32, seed & 0xFFFFFFFF)
  of uint32 words; Flax folds into it, once per parameter, the first
  four bytes (big-endian) of the SHA-1 of the parameter's module path
  and its creation count within its module (a kernel is its module's
  first parameter, count 1), through ``fold_in(key, d)``, which is
  ``threefry2x32(key, (0, d))``;
- the bits: ``threefry2x32(key, (hi, lo))`` of the 64-bit row-major
  index of each element, the two output words XORed (JAX's
  partitionable bit generation, the default);
- the draw: the top 23 bits as a uniform in [1, 2), moved to
  [erf(-sqrt 2), erf(sqrt 2)), then ``sqrt(2) * erfinv``, clipped inside
  (-2, 2), times ``sqrt(1 / fan_in) / 0.8796...``, in fp32.

The bits are JAX's exactly. ``erf`` and ``erfinv`` are taken in fp64 and
rounded, where XLA uses fp32 approximations, so a drawn weight may differ
from JAX's in its last bits (``tests/test_torch_train_segmenter.py``
holds the tree against ``model.init`` to 2e-6 relative).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
from scipy.special import erf, erfinv

from acmpc_tpu_torch.models.fpn_resnet18 import FPNResNet18, flax_tree_from_state_dict

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the std of a unit normal truncated to (-2, 2), Flax's constant
TRUNCATED_STD = 0.87962566103423978


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the uint32 count pairs
    (x1, x2) under the uint32 key pair."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)``'s two uint32 words."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def fold_in(key: tuple, data: int) -> tuple[int, int]:
    """``fold_in(key, data)`` for a uint32 ``data``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return int(a[0]), int(b[0])


def fold_in_path(key: tuple, path: tuple) -> tuple[int, int]:
    """Flax's static fold of a module path and a count into ``key``."""
    digest = hashlib.sha1()
    for part in path:
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], byteorder="big"))


def random_bits(key: tuple, shape: tuple) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    n = math.prod(shape)
    index = np.arange(n, dtype=np.uint64)
    hi, lo = threefry2x32(key, (index >> np.uint64(32)).astype(np.uint32), index.astype(np.uint32))
    return (hi ^ lo).reshape(shape)


def truncated_normal(key: tuple, shape: tuple) -> np.ndarray:
    """A unit normal truncated to (-2, 2), fp32."""
    f32 = np.float32
    sqrt2 = f32(np.sqrt(2.0))
    lo, hi = f32(erf(f32(-2.0) / sqrt2)), f32(erf(f32(2.0) / sqrt2))
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - f32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    out = sqrt2 * erfinv(u.astype(np.float64)).astype(np.float32)
    return np.clip(out, np.nextafter(f32(-2.0), f32(np.inf)), np.nextafter(f32(2.0), f32(-np.inf)))


def lecun_normal(key: tuple, shape: tuple) -> np.ndarray:
    """Flax's default kernel initialiser for an HWIO ``shape`` (fan in
    = H * W * I)."""
    f32 = np.float32
    std = np.sqrt(f32(1.0 / math.prod(shape[:-1]))) / f32(TRUNCATED_STD)
    return truncated_normal(key, shape) * std


def init_variables(seed: int = 0, num_classes: int = 10) -> dict:
    """The Flax variables tree (numpy leaves) that
    ``FPNResNet18(num_classes).init(PRNGKey(seed), x)`` returns: kernels
    ``lecun_normal``, convolution biases 0, norm scales 1 and biases 0,
    BatchNorm mean 0 and var 1."""
    tree = flax_tree_from_state_dict(FPNResNet18(num_classes=num_classes).state_dict())
    key = prng_key(seed)

    def fill(params: dict, stats: dict | None, path: tuple):
        for name, value in params.items():
            if isinstance(value, dict):
                fill(value, (stats or {}).get(name), (*path, name))
            elif name == "kernel":  # each module's first parameter
                params[name] = lecun_normal(fold_in_path(key, (*path, 1)), value.shape)
            elif name == "scale":
                params[name] = np.ones_like(value)
            else:
                params[name] = np.zeros_like(value)
        if stats is not None and "mean" in stats:
            stats["mean"] = np.zeros_like(stats["mean"])
            stats["var"] = np.ones_like(stats["var"])

    fill(tree["params"], tree["batch_stats"], ())
    return tree
