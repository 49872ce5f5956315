"""Segmentation inference runner.

Counterpart of ``acmpc_tpu/perception/segmentation.py``: load the
weights, normalise the frame, run the FPN, take the class argmax, and
zero the classes above 1 to get the drivable mask. The FPN runs in the
configured precision as parameters and inputs of that dtype (no
autocast), so the casts sit where the JAX package has them: the stored
(fp16) parameters cast to the compute dtype at load, the frame cast and
then divided by 255.

``TrackSegmenterAOT`` (the JAX package's ahead-of-time compiled
variant) captures the forward as a CUDA graph at construction for the
configured frame shape (``ops/graph_loop.GraphCache``: one eager frame
chooses cuDNN's algorithms, then the capture), and replays it for every
frame; on the CPU it runs one warm frame.

Deliberate difference from the JAX package: a missing checkpoint raises
``FileNotFoundError``; it never falls back to random weights. Callers
that want other weights pass ``variables``, a Flax variables tree of
numpy arrays.
"""

from __future__ import annotations

import pathlib

import torch

from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.models.checkpoint import read_checkpoint, write_checkpoint
from acmpc_tpu_torch.models.fpn_resnet18 import (
    FPNResNet18,
    convert_torch_state_dict,
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from acmpc_tpu_torch.ops.graph_loop import GraphCache

PRECISION = {
    "full": torch.float32,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


def load_variables(path: str | pathlib.Path) -> dict:
    """The Flax variables tree (numpy leaves, stored dtypes) of a
    ``.msgpack`` (Flax serialization) or smp ``.pt``/``.pth`` checkpoint.
    Raises ``FileNotFoundError`` when the file is missing."""
    p = pathlib.Path(path)
    if not p.is_file():
        raise FileNotFoundError(
            f"segmentation checkpoint {p} does not exist (perception.model_path)"
        )
    if p.suffix == ".msgpack":
        return read_checkpoint(p)
    if p.suffix in (".pt", ".pth"):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    raise ValueError(f"unknown weight format: {p.suffix}")


class TrackSegmenter:
    def __init__(
        self,
        cfg: PerceptionConfig,
        variables: dict | None = None,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self._width = cfg.image_width
        self._height = cfg.image_height
        self._dtype = PRECISION[cfg.precision]
        if variables is None:
            variables = self.load_variables(cfg.model_path)
        model = FPNResNet18(num_classes=10)
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        # floating parameters cast from the stored dtype to the compute
        # dtype, as the JAX package does at load
        self.model = (
            model.to(device=self.device, dtype=self._dtype, memory_format=torch.channels_last)
            .eval()
            .requires_grad_(False)
        )

    def load_variables(self, path: str | pathlib.Path) -> dict:
        """The checkpoint's variables tree (:func:`load_variables`)."""
        return load_variables(path)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def save_variables(self, path: str | pathlib.Path):
        """Write the model's parameters, in the compute dtype (bf16 as
        fp32, which numpy lacks), as a Flax msgpack checkpoint."""
        write_checkpoint(path, flax_tree_from_state_dict(self.model.state_dict()))

    # -- inference -------------------------------------------------------
    @torch.no_grad()
    def _apply(self, image: torch.Tensor):
        """image: (H, W, 3) uint8 on the model's device -> (drivable
        (H, W) uint8, semantics (H, W) uint8)."""
        x = image.to(self._dtype) / 255.0
        logits = self.model(x[None])
        semantics = torch.argmax(logits, dim=-1)[0].to(torch.uint8)
        drivable = torch.where(semantics > 1, 0, semantics).to(torch.uint8)
        return drivable, semantics

    def segment_drivable_area(self, image):
        """(drivable_mask, semantics) of one (H, W, 3) uint8 frame."""
        return self._apply(torch.as_tensor(image, device=self.device))


class TrackSegmenterAOT(TrackSegmenter):
    """The compiled variant: the forward of the configured frame shape is
    captured as a CUDA graph at construction (the counterpart of JAX's
    ``jit(_apply).lower(...).compile()``), and ``segment_drivable_area``
    replays it."""

    def __init__(
        self,
        cfg: PerceptionConfig,
        variables: dict | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__(cfg, variables, device)
        self._compiled = GraphCache(self._apply, "TrackSegmenter._apply")
        dummy = torch.zeros(
            (self._height, self._width, 3), dtype=torch.uint8, device=self.device
        )
        self._compiled(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def segment_drivable_area(self, image):
        """(drivable_mask, semantics) of one (H, W, 3) uint8 frame, through
        the captured forward."""
        return tuple(self._compiled(torch.as_tensor(image, device=self.device)))
