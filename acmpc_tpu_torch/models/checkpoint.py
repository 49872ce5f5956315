"""Flax's msgpack checkpoint format, read and written without Flax.

``flax.serialization.to_bytes`` writes a state dict (nested dicts with
ndarray leaves) as msgpack, each ndarray as an ext object of type 1
whose payload is itself msgpack: ``(shape, dtype name, C-order bytes)``;
a numpy scalar is type 3 with the same payload (a 0-d array). Arrays
over 2**30 bytes are split into a ``__msgpack_chunked_array__`` dict.
This module reads and writes that format with the ``msgpack`` package
alone, so the shipped segmentation checkpoint loads where Flax is not
installed. It refuses what it does not know: a missing, empty or
truncated file, an unknown ext type, a chunked array (the shipped
checkpoints have none). A bfloat16 array (what the JAX package saves
at bf16 precision) is read as the fp32 array of the same values, since
numpy has no bfloat16.
"""

from __future__ import annotations

import pathlib

import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _array_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen to the fp32 of the same value (a
        # bf16 is the high half of an fp32)
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    try:
        dtype = np.dtype(dtype_name.decode())
    except TypeError as err:
        raise ValueError(f"unknown dtype {dtype_name!r} in checkpoint") from err
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"unknown msgpack ext type {code} in checkpoint")


def _refuse_chunked(tree, path: str = ""):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                f"chunked array at {path or '/'}: arrays over 2**30 bytes are not supported"
            )
        for key, value in tree.items():
            _refuse_chunked(value, f"{path}/{key}")


def msgpack_restore(data: bytes) -> dict:
    """The state dict in ``data`` (Flax's msgpack format)."""
    if not data:
        raise ValueError("empty checkpoint")
    try:
        tree = msgpack.unpackb(data, ext_hook=_ext_hook, raw=False)
    except (msgpack.exceptions.ExtraData, msgpack.exceptions.UnpackException, ValueError) as err:
        raise ValueError(f"damaged checkpoint: {err}") from err
    if not isinstance(tree, dict):
        raise ValueError(f"checkpoint holds a {type(tree).__name__}, not a state dict")
    _refuse_chunked(tree)
    return tree


def read_checkpoint(path: str | pathlib.Path) -> dict:
    """Read a Flax msgpack checkpoint: nested dicts of numpy arrays, in
    the stored dtypes. Raises ``FileNotFoundError`` for a missing file and
    ``ValueError`` for an empty or damaged one."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    return msgpack_restore(path.read_bytes())


def _pack(value):
    if isinstance(value, np.ndarray):
        if value.dtype.hasobject or value.dtype.fields is not None:
            raise ValueError(f"cannot store dtype {value.dtype}")
        if value.nbytes > 2**30:
            raise ValueError("arrays over 2**30 bytes are not supported")
        payload = (value.shape, value.dtype.name, np.ascontiguousarray(value).tobytes("C"))
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(payload, use_bin_type=True))
    if isinstance(value, np.generic):
        arr = np.asarray(value)
        payload = (arr.shape, arr.dtype.name, arr.tobytes("C"))
        return msgpack.ExtType(_EXT_NPSCALAR, msgpack.packb(payload, use_bin_type=True))
    raise TypeError(f"cannot store {type(value).__name__} in a checkpoint")


def msgpack_serialize(tree: dict) -> bytes:
    """``tree`` (nested dicts of numpy arrays) in Flax's msgpack format."""
    return msgpack.packb(tree, default=_pack, strict_types=True)


def write_checkpoint(path: str | pathlib.Path, tree: dict) -> None:
    pathlib.Path(path).write_bytes(msgpack_serialize(tree))
