"""One car's camera, perception only, closed loop, with Mask2Former-R50 as
the segmenter: each request is the racing agent's perception worker on
one host frame, ``Perceiver.perceive`` (the upload, then one graph of the
JPEG round trip, Mask2Former and the extraction), and the left, right
and centre tracks to the host as the agent copies them.

The segmenter is the configuration's (``perception.architecture``) at
the widths the configuration's top-level keys state (``transformers``'
``Mask2FormerConfig`` names). No trained checkpoint is in the
repository, so its weights are drawn here from the run's seed
(``reference/mask2former.random_state``), and a few rows of its heads are
set from two frames of the pool (``fit_heads``): about half of each
frame comes out drivable, in the shape of the track, and some queries'
masks are empty, so that the attention releases their rows. The frames
are ``perceive``'s pool (``frames.py``), fed in order and cycled.

After the window, on a seeded sample of the pool's frames as the
program segmented each on its last pass through the window, against the
plain Mask2Former in float32 on the frame's own JPEG round trip, fed the
program's own attention masks layer by layer (teacher forcing: a bit
that rounding flips at ``sigmoid = 0.5`` would otherwise send the two
decoders over different keys):

- ``class_gap``, ``mask_logit_gap``: the program's final class logits
  and mask logits at 1/4 against the reference's, the largest absolute
  difference over the reference's largest absolute value;
- ``encoder_gap``: the same of the deformable encoder's output tokens:
  the decoder's own bf16 rounding (nine post-norm layers) hides in the
  final logits an encoder a few times less precise than bf16 (such as
  sampling locations rounded to bf16), which this number shows;
- ``attn_mask_gap``: the share of the nine attention masks' bits where
  the program's differs from the reference's own threshold of its own
  logits, counted where those logits decide the bit by more than twice
  ``mask_logit_gap``'s limit times the layer's largest absolute logit;
- ``mask_gap``: the share of the frame's pixels where the program's
  drivable mask differs from the plain semantic inference (float32) of
  the program's own final logits, counted where those scores decide the
  pixel's drivable class by more than ``SCORE_MARGIN`` of the largest
  score: the semantic stage (resize, sigmoid, product, argmax, the
  drivable rule) judged from its own input; a margin tied to the logit
  limits through the hundred queries' softmax and sigmoid would decide
  no pixel;
- ``tracks_gap`` (metres): as ``perceive``'s.

The limits (the traffic file's), each between the largest reading of
sound runs and the smallest of the float8 control on an H100 (PERF.md
§6 has the readings): ``class_gap`` 0.13 (sound up to 0.066, control
from 0.27), ``mask_logit_gap`` 0.22 (0.145; 0.36), ``encoder_gap`` 0.06
(0.035; 0.139; nearer the sound side so that sampling locations rounded
to bf16, 0.084 at 960x544, fail), ``attn_mask_gap`` and ``mask_gap``
1e-5 (0 on every sound run: a decided bit or pixel that differs is a
fault), ``tracks_gap`` 0.02 m (``perceive``'s).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import frames, judge, program
from perfbench.drivers.camera import jpeg_round_trip
from perfbench.drivers.perceive import asphalt, fits_gap
from perfbench.reference import mpc as R
from perfbench.reference import sweep as S
from perfbench.reference import tracks as T
from perfbench.reference.mask2former import SHAPE_KEYS, Mask2Former, fit_heads, random_state

# the program's semantic inference rounds its resized mask logits, the
# sigmoids, the class probabilities and the scores to bf16 (2^-9
# relative each); a pixel is decided where the drivable class leads, or
# trails, the best other by more than this share of the frame's largest
# score, some four times what those roundings move a score
SCORE_MARGIN = 0.02


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.cam = config["agent"]["perception"]
        self.spans = self.host_spans = None
        self.frames_done = 0
        self.kept: dict = {}
        self.recording = False
        self.k = 0
        self.logits = None
        self.fits_judged: list = []

    def setup(self):
        from acmpc_tpu_torch.config.schema import PerceptionConfig
        from acmpc_tpu_torch.perception.perceiver import Perceiver

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
            self.logits = out.logits
            return out

        return tapped

    def request(self) -> float:
        f = self.k % len(self.pool)
        self.k += 1
        frame = self.pool[f]
        t0 = time.perf_counter()
        out = self.perceiver.perceive(frame)
        if self.spans is not None:
            torch.cuda.synchronize() if self.device.type == "cuda" else None
            self.spans.setdefault("perception", []).append(time.perf_counter() - t0)
        t_c = time.perf_counter()
        for name in ("left", "right", "centreline"):
            out[name].cpu().numpy()
        t1 = time.perf_counter()
        if self.host_spans is not None:
            self.host_spans += [("perceive", t0, t_c), ("tracks_to_host", t_c, t1)]
        if self.recording:
            self.frames_done += 1
            if f in self.check_frames:  # the frame's last pass in the window
                self.kept[f] = {"logits": self.logits, "drivable": out["drivable"],
                                **{k: out[k] for k in ("left_raw", "left_raw_mask", "right_raw", "right_raw_mask",
                                                        "left", "right")},
                                "centre": out["centreline"]}
        return t1 - t0

    def counters(self) -> dict:
        from acmpc_tpu_torch.ops.ms_deform_attn import ms_deform_attn

        out = program.launch_counts()  # settles the graphs' launches first
        out.update(requests=self.frames_done, frames=self.frames_done,
                   ms_deform_attn=sum(ms_deform_attn.launches.values()))
        return out

    def shapes(self) -> dict:
        return {"batch": 1}

    def frame_shape(self) -> tuple:
        return self.cam["image_height"], self.cam["image_width"]

    def attempted(self) -> int:
        return self.frames_done

    def failed(self) -> int:
        return 0

    def release(self):
        self.perceiver = None

    def _reference(self, fp8: bool = False) -> Mask2Former:
        return Mask2Former(self.variables, self.config, self.device, fp8=fp8)

    def check(self) -> list:
        if not self.frames_done:
            return []
        limits = self.traffic
        # a sampled frame the window never served leaves nothing judged: not correct
        class_gap = float("inf") if len(self.kept) < len(self.check_frames) else 0.0
        mask_logit_gap = encoder_gap = attn_mask_gap = mask_gap = tracks_gap = 0.0
        ref = self._reference()
        self.fits_judged, shares = [], []
        for f, got in self.kept.items():
            cls, mask, memory, *masks = got["logits"]
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            want = ref.forward(image, [m[0] for m in masks])
            class_gap = judge.worst(class_gap, relative_gap(cls[0], want["class_logits"]))
            mask_logit_gap = judge.worst(mask_logit_gap, relative_gap(mask[0], want["mask_logits"]))
            encoder_gap = judge.worst(encoder_gap, relative_gap(memory[0], want["memory"]))
            attn_mask_gap = judge.worst(attn_mask_gap, bits_gap([m[0] for m in masks], want["attn_logits"],
                                                                 limits["mask_logit_gap_limit"]))
            scores = Mask2Former.semantic(cls[0].float(), mask[0].float(), image.shape[:2])
            mask_gap = judge.worst(mask_gap, decided_gap(got["drivable"], scores))
            gap, judged = fits_gap(got, got["drivable"].cpu().numpy(), self.cam, self.device)
            tracks_gap = judge.worst(tracks_gap, gap)
            self.fits_judged.append(judged)
            shares.append(round(float(got["drivable"].float().mean()), 4))
        print(f"perceive_m2f: fitted polylines judged a frame (of 3): {self.fits_judged}; drivable share a frame: "
              f"{shares}", file=sys.stderr)
        return [("class_gap", class_gap, limits["class_gap_limit"]),
                ("mask_logit_gap", mask_logit_gap, limits["mask_logit_gap_limit"]),
                ("encoder_gap", encoder_gap, limits["encoder_gap_limit"]),
                ("attn_mask_gap", attn_mask_gap, limits["attn_mask_gap_limit"]),
                ("mask_gap", mask_gap, limits["mask_gap_limit"]),
                ("tracks_gap", tracks_gap, limits["tracks_gap_limit"])]

    def control(self) -> list:
        """The compared numbers of the control: the Mask2Former with float8
        e4m3 products, fed the program's attention masks as the reference
        is, against the float32 reference (its logits, its own threshold's
        bits, and its mask where the reference's scores decide the pixel),
        the extraction with TF32 products on the control's own mask."""
        ref, low = self._reference(), self._reference(fp8=True)
        class_gap = mask_logit_gap = encoder_gap = attn_mask_gap = mask_gap = tracks_gap = 0.0
        limit = self.traffic["mask_logit_gap_limit"]
        for f, got in self.kept.items():
            masks = [m[0] for m in got["logits"][3:]]
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            want, o = ref.forward(image, masks), low.forward(image, masks)
            class_gap = judge.worst(class_gap, relative_gap(o["class_logits"], want["class_logits"]))
            mask_logit_gap = judge.worst(mask_logit_gap, relative_gap(o["mask_logits"], want["mask_logits"]))
            encoder_gap = judge.worst(encoder_gap, relative_gap(o["memory"], want["memory"]))
            own = [logits.sigmoid() < 0.5 for logits in o["attn_logits"]]
            attn_mask_gap = judge.worst(attn_mask_gap, bits_gap(own, want["attn_logits"], limit))
            scores = Mask2Former.semantic(o["class_logits"], o["mask_logits"], image.shape[:2])
            m = (torch.argmax(scores, dim=0) == 1).to(torch.uint8)
            mask_gap = judge.worst(mask_gap, decided_gap(
                m, Mask2Former.semantic(want["class_logits"], want["mask_logits"], image.shape[:2])))
            m = m.cpu().numpy()
            tracks = T.extract(m, self.cam, torch.float32, self.device, R.Arith(tf32=True))
            tracks_gap = judge.worst(tracks_gap, fits_gap(tracks, m, self.cam, self.device)[0])
        return [("class_gap", class_gap), ("mask_logit_gap", mask_logit_gap), ("encoder_gap", encoder_gap),
                ("attn_mask_gap", attn_mask_gap), ("mask_gap", mask_gap), ("tracks_gap", tracks_gap)]


def built_shape(cfg) -> dict:
    """The shape of the program's ``Mask2FormerConfig`` under the
    configuration's keys."""
    out = {k: getattr(cfg, k) for k in SHAPE_KEYS if k != "backbone_config"}
    out["backbone_config"] = {"embedding_size": cfg.embedding_size, "hidden_sizes": list(cfg.hidden_sizes),
                              "depths": list(cfg.depths)}
    return out


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference over the reference's largest
    absolute value."""
    gap = torch.abs(got.to(want.device).double() - want.double()).max()
    return float(gap / torch.abs(want).max().double())


def bits_gap(got: list, want_logits: list, limit: float) -> float:
    """The share of the masks' bits (True: blocked) where ``got`` differs
    from ``sigmoid(want) < 0.5``, counted where |want| exceeds twice
    ``limit`` times the layer's largest |want|."""
    wrong = total = 0
    for bits, logits in zip(got, want_logits):
        decided = torch.abs(logits) > 2.0 * limit * torch.abs(logits).max()
        wrong += int((decided & (bits.to(logits.device).bool() != (logits.sigmoid() < 0.5))).sum())
        total += logits.numel()
    return wrong / max(total, 1)


def decided_gap(drivable: torch.Tensor, scores: torch.Tensor) -> float:
    """The share of the (H, W) pixels where ``drivable`` differs from the
    drivable class of the (K, H, W) ``scores`` where those decide it
    (class 1 against the largest other) by more than SCORE_MARGIN of the
    largest score."""
    other = torch.cat([scores[:1], scores[2:]]).amax(dim=0)
    margin = scores[1] - other
    decided = torch.abs(margin) > SCORE_MARGIN * float(scores.max())
    wrong = decided & ((margin > 0) != drivable.to(device=scores.device).bool())
    return float(wrong.double().mean())
