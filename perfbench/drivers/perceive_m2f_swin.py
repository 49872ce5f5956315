"""One car's camera, perception only, closed loop, with Mask2Former-Swin-L as
the segmenter: ``perceive_m2f``'s requests, frames and judge, with the
Swin-L backbone (``perception.architecture: mask2former_swin_l``) in
place of the ResNet-50.

The segmenter is built at the widths the configuration states
(``transformers``' ``Mask2FormerConfig`` names, the backbone's
``SwinConfig``'s), its weights drawn from the run's seed
(``reference/swin.random_state``) and a few rows of its heads set from two
frames of the pool (``reference/swin.fit_heads``). After the window, on
the seeded sample of judged frames, against the plain Mask2Former-Swin-L
in float32 fed the program's attention masks (teacher forcing), the
``perceive_m2f`` checks (``class_gap``, ``mask_logit_gap``,
``encoder_gap``, ``attn_mask_gap``, ``mask_gap``, ``tracks_gap``), and:

- ``backbone_gap``: the program's res2-res5 (the Swin backbone's outputs,
  after its out-norms, which the timed path hands out after the masks)
  against the reference's, the largest absolute difference over the
  reference's largest absolute value, the worst of the four maps.

The limits are the traffic file's, each between the largest reading of
sound runs and the smallest of the float8 control on an H100 (PERF.md
§6 has the readings).

A program that has no such segmenter refuses the configuration before
any frame is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import frames, judge
from perfbench.drivers import perceive_m2f as base
from perfbench.drivers.camera import jpeg_round_trip
from perfbench.drivers.perceive import asphalt
from perfbench.reference import sweep as S
from perfbench.reference.swin import SHAPE_KEYS, SWIN_KEYS, Mask2Former, fit_heads, random_state

FEATURES = 4  # res2-res5, the last outputs of the Swin-backed segmenter


class Cell(base.Cell):
    def setup(self):
        from acmpc_tpu_torch.config.schema import PerceptionConfig
        from acmpc_tpu_torch.perception import segmentation
        from acmpc_tpu_torch.perception.perceiver import Perceiver

        arch = self.cam["architecture"]
        if arch not in segmentation.ARCHITECTURES:
            raise ValueError(f"the program has no segmenter {arch!r}: {segmentation.ARCHITECTURES}")
        t = self.traffic
        rng = np.random.default_rng(self.seed)
        centre = S.load_centre(t["map"])
        rows = frames.poses(centre, rng, t["clips"], t["pool"] // t["clips"], t["frame_step_m"],
                            t["offset_amp_m"], t["yaw_jitter_deg"])
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2 ** 62)))
        self.pool = frames.render(centre, self.cam, rows, t["half_width_m"], gen, self.device)
        self.check_frames = set(int(i) for i in rng.choice(len(self.pool), t["check_frames"], replace=False))
        fit = [jpeg_round_trip(self.pool[i]) for i in (0, len(self.pool) // 2)]
        self.variables = fit_heads(random_state(self.seed, self.config), self.config, fit,
                                   [asphalt(image) for image in fit], self.device)
        cfg = PerceptionConfig.from_config(self.cam)
        self.perceiver = Perceiver(cfg, self.variables, device=self.device, keep_logits=True)
        built = built_shape(self.perceiver.segmenter.model.config)
        stated = {k: self.config[k] for k in SHAPE_KEYS}
        stated["backbone_config"] = {k: stated["backbone_config"][k] for k in built["backbone_config"]}
        if built != stated:
            raise ValueError(f"the program's segmenter is not the configuration's: {built} against {stated}")
        for name in ("_pipeline", "_raw_pipeline"):  # the logits of what the timed path returns
            setattr(self.perceiver, name, self._tap(getattr(self.perceiver, name)))
        for _ in range(t["warm_requests"]):
            self.request()
        self.k = 0
        self.recording = True

    def _tap(self, pipeline):
        def tapped(image):
            out = pipeline(image)
            self.logits, self.features = out.logits[:-FEATURES], out.logits[-FEATURES:]
            return out

        return tapped

    def request(self) -> float:
        f = self.k % len(self.pool)
        latency = super().request()
        if f in self.kept:
            self.kept[f]["features"] = self.features
        return latency

    def counters(self) -> dict:
        from acmpc_tpu_torch.ops.window_attention import window_attention

        out = super().counters()  # settles the graphs' launches first
        out["window_attention"] = sum(window_attention.launches.values())
        return out

    def _reference(self, fp8: bool = False) -> Mask2Former:
        return Mask2Former(self.variables, self.config, self.device, fp8=fp8)

    def check(self) -> list:
        checks = super().check()
        if not checks:
            return checks
        ref = self._reference()
        gap = float("inf") if len(self.kept) < len(self.check_frames) else 0.0
        for f, got in self.kept.items():
            want = ref.backbone_maps(torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device))
            gap = judge.worst(gap, *(base.relative_gap(a[0], b) for a, b in zip(got["features"], want)))
        return checks + [("backbone_gap", gap, self.traffic["backbone_gap_limit"])]

    def control(self) -> list:
        """``perceive_m2f``'s control numbers and the float8 backbone's
        res2-res5 against the float32 reference's."""
        ref, low = self._reference(), self._reference(fp8=True)
        gap = 0.0
        for f in self.kept:
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            gap = judge.worst(gap, *(base.relative_gap(a, b) for a, b in zip(low.backbone_maps(image),
                                                                                ref.backbone_maps(image))))
        return super().control() + [("backbone_gap", gap)]


def built_shape(cfg) -> dict:
    """The shape of the program's ``Mask2FormerConfig`` under the
    configuration's keys."""
    out = {k: getattr(cfg, k) for k in SHAPE_KEYS if k != "backbone_config"}
    b = cfg.backbone_config
    out["backbone_config"] = {"model_type": cfg.backbone,
                              **{k: list(v) if isinstance(v, tuple) else v for k, v in
                                 ((k, getattr(b, k)) for k in SWIN_KEYS)}}
    return out
