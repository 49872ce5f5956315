"""Device policy: entry points run on the GPU unless the caller names
another device. There is no silent CPU fallback."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA. Raises when
    CUDA is asked for and no card is visible."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def scalar(value, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype, device)``, with a Python number
    filled on the device instead of copied from host memory: a fill
    queues no synchronisation and can be captured in a CUDA graph."""
    if type(value) in (bool, int, float):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array (a list, tuple or numpy array of numbers) as a tensor
    on ``device``, copied once and cached per value, dtype and device: a
    copy from host memory cannot be captured in a CUDA graph, and the
    cached tensor is made by the eager call that precedes a capture. The
    caller must not write to it."""
    a = np.asarray(values)
    return _constant(a.tobytes(), a.dtype.str, a.shape, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(data: bytes, np_dtype: str, shape: tuple, dtype: torch.dtype, device: torch.device):
    a = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    return torch.as_tensor(a, dtype=dtype, device=device)
