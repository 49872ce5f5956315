"""Segmentation inference runner.

Counterpart of ``acmpc_tpu/perception/segmentation.py``: load the
weights, normalise the frame, run the segmenter, take the class argmax,
and zero the classes above 1 to get the drivable mask. The segmenter is
the one ``perception.architecture`` names (``ARCHITECTURES``): the
FPN-ResNet18 of the JAX package (``fpn_resnet18``, the default),
SegFormer-B2 (``segformer_b2``), Mask2Former-R50 (``mask2former_r50``) or
Mask2Former-Swin-L (``mask2former_swin_l``), the port's own; each has
one entry in ``ENTRIES`` (its model, weight loader and saver, input and
logits-to-frame rules). It runs in the
configured precision as parameters and inputs of that dtype (no
autocast), so the casts sit where the JAX package has them: the stored
parameters cast to the compute dtype at load, the frame cast and then
divided by 255 (Mask2Former normalises the frame itself, in float32, by
the published mean and deviation).

Weights: the FPN's are a Flax variables tree (a ``.msgpack`` checkpoint,
or an smp ``.pt``/``.pth`` state dict converted to one); SegFormer's a
state dict under ``transformers``' names, Mask2Former's under
detectron2's (a ``.pt``/``.pth`` file of ``torch.save``). ``variables``
passes either form directly.

``TrackSegmenterAOT`` (the JAX package's ahead-of-time compiled
variant) captures the forward as a CUDA graph at construction for the
configured frame shape (``ops/graph_loop.GraphCache``: one eager frame
chooses cuDNN's algorithms, then the capture), and replays it for every
frame; on the CPU it runs one warm frame.

Deliberate difference from the JAX package: a missing checkpoint raises
``FileNotFoundError``; it never falls back to random weights. Callers
that want other weights pass ``variables``.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable

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
from acmpc_tpu_torch.models.mask2former import Mask2Former, Mask2FormerConfig, semantic_scores
from acmpc_tpu_torch.models.segformer import SegformerForSemanticSegmentation, to_frame
from acmpc_tpu_torch.models.swin import SwinConfig
from acmpc_tpu_torch.ops.graph_loop import GraphCache
from acmpc_tpu_torch.utils.monitor import MONITOR

PRECISION = {
    "full": torch.float32,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


FPN = "fpn_resnet18"
SEGFORMER = "segformer_b2"
MASK2FORMER = "mask2former_r50"
MASK2FORMER_SWIN_L = "mask2former_swin_l"


@dataclasses.dataclass(frozen=True)
class Architecture:
    """How the segmenter that one ``perception.architecture`` names is
    built, fed, read, loaded and saved."""

    model: Callable[[], torch.nn.Module]  # the model, 10 classes
    state_dict: Callable[[dict], dict]  # the weights as the model's state dict
    load: Callable[[pathlib.Path], dict]  # a checkpoint file -> the weights
    save: Callable[[dict, pathlib.Path], None]  # the model's state dict -> a checkpoint file
    inputs: Callable[[torch.Tensor, torch.dtype], torch.Tensor]  # (H, W, 3) uint8 -> the model's frame
    semantics: Callable[..., torch.Tensor]  # (the model's output, H, W) -> the (H, W) class map


def _unknown_format(architecture: str, p: pathlib.Path):
    return ValueError(f"unknown weight format for {architecture}: {p.suffix}")


def _load_fpn(p: pathlib.Path) -> dict:
    """The Flax variables tree (numpy leaves, stored dtypes) of a
    ``.msgpack`` (Flax serialization) or smp ``.pt``/``.pth`` checkpoint."""
    if p.suffix == ".msgpack":
        return read_checkpoint(p)
    if p.suffix in (".pt", ".pth"):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    raise _unknown_format(FPN, p)


def _state_dict_loader(architecture: str):
    def load(p: pathlib.Path) -> dict:
        """The state dict of a ``.pt``/``.pth`` file of ``torch.save``."""
        if p.suffix in (".pt", ".pth"):
            return torch.load(p, map_location="cpu", weights_only=True)
        raise _unknown_format(architecture, p)

    return load


def _save_state_dict(state: dict, path: pathlib.Path):
    """A ``torch.save`` state dict, bf16 as fp32."""
    torch.save({k: (v.float() if v.dtype == torch.bfloat16 else v).cpu() for k, v in state.items()}, path)


def _tensors(variables: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in variables.items()}


def _scaled(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The frame cast to the compute dtype, then divided by 255."""
    return image.to(dtype) / 255.0


def _mask2former_semantics(out, h: int, w: int) -> torch.Tensor:
    """The class map of Mask2Former's semantic inference at the frame."""
    return torch.argmax(semantic_scores(out[0], out[1], h, w), dim=1)[0]


ENTRIES = {
    # the FPN: a Flax checkpoint, float32 logits at the frame
    FPN: Architecture(
        model=lambda: FPNResNet18(num_classes=10), state_dict=state_dict_from_flax, load=_load_fpn,
        save=lambda state, path: write_checkpoint(path, flax_tree_from_state_dict(state)), inputs=_scaled,
        semantics=lambda logits, h, w: torch.argmax(logits, dim=-1)[0],
    ),
    # SegFormer: logits at stage 1's grid, resized to the frame
    SEGFORMER: Architecture(
        model=SegformerForSemanticSegmentation, state_dict=_tensors, load=_state_dict_loader(SEGFORMER),
        save=_save_state_dict, inputs=_scaled,
        semantics=lambda logits, h, w: torch.argmax(to_frame(logits, h, w), dim=-1)[0],
    ),
    # Mask2Former: the frame normalised by the model; semantic inference
    # of the final class and mask logits at the frame
    MASK2FORMER: Architecture(
        model=Mask2Former, state_dict=_tensors, load=_state_dict_loader(MASK2FORMER), save=_save_state_dict,
        inputs=lambda image, dtype: image, semantics=_mask2former_semantics,
    ),
    # the same with Swin-L in place of the ResNet
    MASK2FORMER_SWIN_L: Architecture(
        model=lambda: Mask2Former(Mask2FormerConfig(backbone_config=SwinConfig())), state_dict=_tensors,
        load=_state_dict_loader(MASK2FORMER_SWIN_L), save=_save_state_dict, inputs=lambda image, dtype: image,
        semantics=_mask2former_semantics,
    ),
}
ARCHITECTURES = tuple(ENTRIES)


def load_variables(path: str | pathlib.Path, architecture: str = FPN) -> dict:
    """The weights of a checkpoint as ``TrackSegmenter`` takes them: for
    the FPN the Flax variables tree (numpy leaves, stored dtypes) of a
    ``.msgpack`` (Flax serialization) or smp ``.pt``/``.pth``
    checkpoint; for SegFormer and the Mask2Formers the state dict of a
    ``.pt``/``.pth`` file. Raises ``FileNotFoundError`` when the file is
    missing."""
    p = pathlib.Path(path)
    if not p.is_file():
        raise FileNotFoundError(
            f"segmentation checkpoint {p} does not exist (perception.model_path)"
        )
    return ENTRIES[architecture].load(p)


def _build_model(architecture: str, variables: dict) -> torch.nn.Module:
    """The named segmenter (10 classes) holding ``variables``, in their
    stored dtypes on the CPU."""
    entry = ENTRIES[architecture]
    model = entry.model()
    model.load_state_dict(entry.state_dict(variables), strict=True)
    return model


class TrackSegmenter:
    architecture = FPN  # the configuration's, set at construction

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
        self.architecture = cfg.architecture
        if cfg.architecture not in ARCHITECTURES:
            raise ValueError(f"perception.architecture {cfg.architecture!r} is none of {ARCHITECTURES}")
        if variables is None:
            variables = self.load_variables(cfg.model_path)
        model = _build_model(cfg.architecture, variables)
        # floating parameters cast from the stored dtype to the compute
        # dtype, as the JAX package does at load
        self.model = (
            model.to(device=self.device, dtype=self._dtype, memory_format=torch.channels_last)
            .eval()
            .requires_grad_(False)
        )

    def load_variables(self, path: str | pathlib.Path) -> dict:
        """The checkpoint's weights for this segmenter's architecture
        (:func:`load_variables`)."""
        return load_variables(path, self.architecture)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def save_variables(self, path: str | pathlib.Path):
        """Write the model's parameters in the compute dtype: the FPN's
        as a Flax msgpack checkpoint (bf16 as fp32, which numpy lacks),
        SegFormer's and Mask2Former's as a ``torch.save`` state dict (bf16
        as fp32 too)."""
        ENTRIES[self.architecture].save(self.model.state_dict(), path)

    # -- inference -------------------------------------------------------
    @torch.no_grad()
    def _apply(self, image: torch.Tensor):
        """image: (H, W, 3) uint8 on the model's device -> (drivable
        (H, W) uint8, semantics (H, W) uint8, the model's own output):
        the FPN's float32 logits (1, H, W, 10), which the argmax reads;
        SegFormer's (1, H / 4, W / 4, 10) in the compute dtype, which the
        argmax reads resized to the frame (``to_frame``); Mask2Former's
        (class logits, mask logits, the 9 attention masks; Swin-L's
        res2-res5 after them), whose semantic inference at the frame the
        argmax reads."""
        entry = ENTRIES[self.architecture]
        logits = self.model(entry.inputs(image, self._dtype)[None])
        semantics = entry.semantics(logits, *image.shape[:2]).to(torch.uint8)
        drivable = torch.where(semantics > 1, 0, semantics).to(torch.uint8)
        return drivable, semantics, logits

    def segment_drivable_area(self, image):
        """(drivable_mask, semantics) of one (H, W, 3) uint8 frame."""
        MONITOR.count(f"segmenter.forward:{self.architecture}")
        return self._apply(torch.as_tensor(image, device=self.device))[:2]


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
        # the masks alone: the logits are no output of the graph
        self._compiled = GraphCache(lambda image: self._apply(image)[:2], "TrackSegmenter._apply")
        dummy = torch.zeros(
            (self._height, self._width, 3), dtype=torch.uint8, device=self.device
        )
        self._compiled(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def segment_drivable_area(self, image):
        """(drivable_mask, semantics) of one (H, W, 3) uint8 frame, through
        the captured forward."""
        MONITOR.count(f"segmenter.forward:{self.architecture}")
        return tuple(self._compiled(torch.as_tensor(image, device=self.device)))
