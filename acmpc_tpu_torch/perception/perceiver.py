"""Perception facade: camera frame -> drivable mask -> BEV track
polylines.

Counterpart of ``acmpc_tpu/perception/perceiver.py``. ``_run_pipeline``
chains segmentation and extraction on the device: the mask stays there
between the stages and nothing is read back, so a caller can queue the
control step behind it. ``_pipeline`` is it compiled, as JAX's
``jax.jit(_run_pipeline)``: on the card one CUDA graph captured at the
first frame of each shape (``ops/graph_loop.GraphCache``), the FPN and
the chain-edges kernel in it.

The pipelines return ``(drivable, semantics, tracks)`` as a
:class:`PipelineOutput`, which also holds the segmenter's own logits
(``logits``; ``TrackSegmenter._apply``; for Mask2Former its final class
and mask logits and its nine attention masks). ``_run_pipeline`` always
hands them out; the captured pipelines only where the perceiver was
built with ``keep_logits=True``, as graph outputs like the others, so
that a caller can judge what the timed path produced. Without it the
graphs neither keep nor copy them.

``perceive`` adds the steps kept from the original stack: the JPEG round
trip that matches the training distribution (OpenCV's default encode and
decode) and the resize guard. Where the perceiver is on the card and the
frame is a uint8 (image_height, image_width, 3) array (the guard would
do nothing), the raw frame is uploaded and one graph replay
runs the round trip (``ops/jpeg_round_trip``, the same bytes as OpenCV's)
and then ``_run_pipeline``. Every other frame takes the host path:
OpenCV's round trip at the frame's own size, the resize, the upload and
``_pipeline``. OpenCV is imported when first used (``ImportError`` where
it is not installed). The monitor's counters ``perceiver.jpeg:device``
and ``perceiver.jpeg:host`` count the frames each way, and
``segmenter.forward:<architecture>`` each frame segmented.
"""

from __future__ import annotations

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.ops.graph_loop import GraphCache
from acmpc_tpu_torch.ops.jpeg_round_trip import jpeg_round_trip
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter
from acmpc_tpu_torch.perception.tracks import (
    TRACK_KEYS,
    TrackExtractionConfig,
    TrackLimitExtractor,
)
from acmpc_tpu_torch.utils.monitor import MONITOR


class PipelineOutput(tuple):
    """``(drivable, semantics, tracks)``, with the segmenter's logits as
    ``logits`` (None where a captured pipeline does not keep them): one
    tensor (the FPN's, SegFormer's), or a tuple of them (Mask2Former's
    class logits, mask logits and nine attention masks)."""

    def __new__(cls, drivable, semantics, tracks, logits):
        out = super().__new__(cls, (drivable, semantics, tracks))
        out.logits = logits
        return out


def _as_list(logits) -> list:
    return list(logits) if isinstance(logits, tuple) else [logits]


class Perceiver:
    def __init__(
        self,
        cfg: PerceptionConfig,
        variables: dict | None = None,
        device: torch.device | str | None = None,
        keep_logits: bool = False,
    ):
        self.cfg = cfg
        self.keep_logits = keep_logits
        self.camera = CameraInfo.from_config(cfg)
        self.segmenter = TrackSegmenter(cfg, variables, device)
        self.device = self.segmenter.device
        self.extractor = TrackLimitExtractor(
            TrackExtractionConfig.from_config(cfg), self.camera, self.device
        )

        def flat(image):
            out = self._run_pipeline(image)
            drivable, semantics, tracks = out
            logits = _as_list(out.logits) if keep_logits else []
            return [drivable, semantics, *(tracks[k] for k in TRACK_KEYS), *logits]

        def raw(image):
            with MONITOR.device_span("perceiver.jpeg", image.device):
                image = jpeg_round_trip(image)
            return flat(image)

        def compiled(fn, name: str):
            graphs = GraphCache(fn, name)

            def pipeline(image: torch.Tensor):
                out = graphs(image)
                tracks = dict(zip(TRACK_KEYS, out[2:2 + len(TRACK_KEYS)]))
                rest = out[2 + len(TRACK_KEYS):]
                logits = (rest[0] if len(rest) == 1 else tuple(rest)) if keep_logits else None
                return PipelineOutput(out[0], out[1], tracks, logits)

            pipeline.graphs = graphs
            return pipeline

        self._pipeline = compiled(flat, "Perceiver._run_pipeline")
        # the raw frame's JPEG round trip on the card, then the pipeline
        self._raw_pipeline = compiled(raw, "Perceiver._run_raw_frame")

    @torch.no_grad()
    def _run_pipeline(self, image: torch.Tensor):
        """image: (H, W, 3) uint8 on the device -> (drivable, semantics,
        tracks) with the logits, all on the device."""
        with MONITOR.device_span("perceiver.segment", image.device):
            drivable, semantics, logits = self.segmenter._apply(image)
        with MONITOR.device_span("perceiver.extract", image.device):
            tracks = self.extractor.extract(drivable)
        return PipelineOutput(drivable, semantics, tracks, logits)

    # -- host preprocessing ---------------------------------------------
    def _encode_decode_image(self, image: np.ndarray) -> np.ndarray:
        """JPEG round trip so inference sees the training distribution."""
        import cv2

        with MONITOR.span("perceiver.jpeg_encode"):
            ok, buf = cv2.imencode(".jpg", image)
        if not ok:
            return image
        with MONITOR.span("perceiver.jpeg_decode"):
            return cv2.imdecode(buf, cv2.IMREAD_COLOR)

    def _ensure_size(self, image: np.ndarray) -> np.ndarray:
        if image.shape[:2] != (self.cfg.image_height, self.cfg.image_width):
            import cv2

            with MONITOR.span("perceiver.resize"):
                image = cv2.resize(
                    image,
                    dsize=(self.cfg.image_width, self.cfg.image_height),
                    interpolation=cv2.INTER_LINEAR,
                )
        return image

    def _round_trip_on_card(self, image) -> bool:
        """Whether the frame's round trip runs on the card: a CUDA
        perceiver, and a frame the resize guard would leave alone."""
        return (
            self.device.type == "cuda"
            and isinstance(image, np.ndarray)
            and image.dtype == np.uint8
            and image.shape == (self.cfg.image_height, self.cfg.image_width, 3)
        )

    # -- public API ------------------------------------------------------
    def perceive(self, image: np.ndarray) -> dict:
        """Full pipeline on one frame. Returns a dict with the drivable
        mask, semantics and BEV track polylines (device tensors)."""
        with MONITOR.span("perceiver.perceive"):
            on_card = self._round_trip_on_card(image)
            MONITOR.count("perceiver.jpeg:device" if on_card else "perceiver.jpeg:host")
            MONITOR.count(f"segmenter.forward:{self.segmenter.architecture}")
            if on_card:
                image = np.ascontiguousarray(image)  # a strided view uploads as its frame
            else:
                image = self._ensure_size(self._encode_decode_image(image))
            with MONITOR.span("perceiver.upload"):
                frame = torch.as_tensor(image, device=self.device)
            with MONITOR.span("perceiver.pipeline"):
                pipeline = self._raw_pipeline if on_card else self._pipeline
                drivable, semantics, tracks = pipeline(frame)
        return {
            "drivable": drivable,
            "semantics": semantics,
            "centreline": tracks["centre"],
            "left": tracks["left"],
            "right": tracks["right"],
            "left_raw": tracks["left_raw"],
            "left_raw_mask": tracks["left_raw_mask"],
            "right_raw": tracks["right_raw"],
            "right_raw_mask": tracks["right_raw_mask"],
        }
