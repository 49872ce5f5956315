"""Perception facade: camera frame -> drivable mask -> BEV track
polylines.

Counterpart of ``acmpc_tpu/perception/perceiver.py``. ``_run_pipeline``
chains segmentation and extraction on the device: the mask stays there
between the stages and nothing is read back, so a caller can queue the
control step behind it. ``_pipeline`` is it compiled, as JAX's
``jax.jit(_run_pipeline)``: on the card one CUDA graph captured at the
first frame of each shape (``ops/graph_loop.GraphCache``), the FPN and
the chain-edges kernel in it. ``perceive`` calls it, and adds the host
steps kept from the
original stack: the JPEG round trip that matches the training
distribution and the resize guard, both through OpenCV, imported when
first used (``ImportError`` where it is not installed).
"""

from __future__ import annotations

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.ops.graph_loop import GraphCache
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter
from acmpc_tpu_torch.perception.tracks import (
    TRACK_KEYS,
    TrackExtractionConfig,
    TrackLimitExtractor,
)
from acmpc_tpu_torch.utils.monitor import MONITOR


class Perceiver:
    def __init__(
        self,
        cfg: PerceptionConfig,
        variables: dict | None = None,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.camera = CameraInfo.from_config(cfg)
        self.segmenter = TrackSegmenter(cfg, variables, device)
        self.device = self.segmenter.device
        self.extractor = TrackLimitExtractor(
            TrackExtractionConfig.from_config(cfg), self.camera, self.device
        )

        def flat(image):
            drivable, semantics, tracks = self._run_pipeline(image)
            return [drivable, semantics, *(tracks[k] for k in TRACK_KEYS)]

        graphs = GraphCache(flat, "Perceiver._run_pipeline")

        def pipeline(image: torch.Tensor):
            out = graphs(image)
            return out[0], out[1], dict(zip(TRACK_KEYS, out[2:]))

        pipeline.graphs = graphs
        self._pipeline = pipeline

    @torch.no_grad()
    def _run_pipeline(self, image: torch.Tensor):
        """image: (H, W, 3) uint8 on the device -> (drivable, semantics,
        tracks), all on the device."""
        with MONITOR.device_span("perceiver.segment", image.device):
            drivable, semantics = self.segmenter._apply(image)
        with MONITOR.device_span("perceiver.extract", image.device):
            tracks = self.extractor.extract(drivable)
        return drivable, semantics, tracks

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

    # -- public API ------------------------------------------------------
    def perceive(self, image: np.ndarray) -> dict:
        """Full pipeline on one frame. Returns a dict with the drivable
        mask, semantics and BEV track polylines (device tensors)."""
        with MONITOR.span("perceiver.perceive"):
            image = self._ensure_size(self._encode_decode_image(image))
            with MONITOR.span("perceiver.upload"):
                frame = torch.as_tensor(image, device=self.device)
            with MONITOR.span("perceiver.pipeline"):
                drivable, semantics, tracks = self._pipeline(frame)
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
