"""Device policy: entry points run on the GPU unless the caller names
another device. There is no silent CPU fallback."""

from __future__ import annotations

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
