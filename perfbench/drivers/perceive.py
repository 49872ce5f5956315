"""One car's camera, perception only, closed loop: each request is the
racing agent's perception worker on one host frame, ``Perceiver.perceive``
(the upload, then one graph of the JPEG round trip, the segmenter and
the extraction), and the left, right and centre tracks to the host as
the agent copies them.

The segmenter is the configuration's (``perception.architecture``) at
the widths the configuration's top-level keys state (``transformers``'
``SegformerConfig`` names). No trained checkpoint is in the repository,
so its weights are drawn here from the run's seed
(``reference/segformer.random_state``: every bias, norm parameter and
statistic non-trivial), and the classifier is fitted to two frames of
the pool (``fit_classifier``) so that the drivable class reads the
asphalt the frames were painted with: about half of each frame comes
out drivable, in the shape of the track. The request stops at the
tracks on the host (a camera-to-command cell waits for trained
weights). The frames are the camera cell's pool (``frames.py``), fed in
order and cycled.

After the window, on a seeded sample of the pool's frames as the
program segmented each on its last pass through the window, against the
plain SegFormer in float32 on the frame's own JPEG round trip:

- ``logit_gap``: the program's logits at stage 1's grid (the graph's
  output, before the resize to the frame) against the reference's, the
  largest absolute difference over the reference's largest absolute
  logit; logits, not the mask, since near-ties flip on rounding;
- ``mask_gap``: the share of the frame's pixels where the program's
  drivable mask differs from the reference's although the reference's
  logits decide the pixel by more than twice ``logit_gap``'s limit (a
  program within that limit at stage 1's grid is within it after the
  bilinear resize, a convex combination): the resize, the argmax and the
  drivable rule;
- ``tracks_gap`` (metres, as in the camera cell): the program's tracks
  against the plain extraction of its own mask, over the polylines that
  the mask determines (``fits_gap``; the number judged per frame goes
  to the error stream).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import frames, judge, program
from perfbench.drivers.camera import MISMATCH_M, jpeg_round_trip
from perfbench.reference import mpc as R
from perfbench.reference import sweep as S
from perfbench.reference import tracks as T
from perfbench.reference.segformer import SHAPE_KEYS, SegFormer, fit_classifier, random_state

# a fitted polyline is determined by its mask when the plain extraction's
# float32 fit lies within this many metres of its float64 fit (a tenth
# of the tracks limit)
DETERMINED_M = 2e-3
# the channels of an asphalt pixel lie within this many levels of each
# other (``asphalt``)
ASPHALT_LEVELS = 20


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
        self.variables = fit_classifier(random_state(self.seed, self.config), self.config, fit,
                                        [asphalt(image) for image in fit], self.device)
        cfg = PerceptionConfig.from_config(self.cam)
        self.perceiver = Perceiver(cfg, self.variables, device=self.device, keep_logits=True)
        built = self.perceiver.segmenter.model.config
        stated = {k: self.config[k] for k in SHAPE_KEYS}
        if any(tuple(np.atleast_1d(v)) != tuple(np.atleast_1d(getattr(built, k))) for k, v in stated.items()):
            raise ValueError(f"the program's segmenter is not the configuration's: {stated}")
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
        out = program.launch_counts()
        out.update(requests=self.frames_done, frames=self.frames_done)
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

    def _reference(self, fp8: bool = False) -> SegFormer:
        return SegFormer(self.variables, self.config, self.device, fp8=fp8)

    def check(self) -> list:
        if not self.frames_done:
            return []
        limits = self.traffic
        # a sampled frame the window never served leaves nothing judged: not correct
        logit_gap = float("inf") if len(self.kept) < len(self.check_frames) else 0.0
        mask_gap = tracks_gap = 0.0
        ref = self._reference()
        self.fits_judged, shares = [], []
        for f, got in self.kept.items():
            want = ref.coarse_logits(torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device))
            logit_gap = judge.worst(logit_gap, logit_distance(got["logits"], want))
            mask_gap = judge.worst(mask_gap, decided_gap(got["drivable"], want, limits["logit_gap_limit"]))
            gap, judged = fits_gap(got, got["drivable"].cpu().numpy(), self.cam, self.device)
            tracks_gap = judge.worst(tracks_gap, gap)
            self.fits_judged.append(judged)
            shares.append(round(float(got["drivable"].float().mean()), 4))
        print(f"perceive: fitted polylines judged a frame (of 3): {self.fits_judged}; drivable share a frame: "
              f"{shares}", file=sys.stderr)
        return [("logit_gap", logit_gap, limits["logit_gap_limit"]),
                ("mask_gap", mask_gap, limits["mask_gap_limit"]),
                ("tracks_gap", tracks_gap, limits["tracks_gap_limit"])]

    def control(self) -> list:
        """The compared numbers of the control: the SegFormer with float8
        e4m3 products against the float32 reference (its logits, and its
        mask where the reference decides the pixel), the extraction with
        TF32 products on the control's own mask."""
        ref, low = self._reference(), self._reference(fp8=True)
        logit_gap = mask_gap = tracks_gap = 0.0
        for f in self.kept:
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            want, got = ref.coarse_logits(image), low.coarse_logits(image)
            logit_gap = judge.worst(logit_gap, logit_distance(got.permute(1, 2, 0)[None], want))
            m = (torch.argmax(SegFormer.resize(got, image.shape[:2]), dim=0) == 1).to(torch.uint8)
            mask_gap = judge.worst(mask_gap, decided_gap(m, want, self.traffic["logit_gap_limit"]))
            m = m.cpu().numpy()
            tracks = T.extract(m, self.cam, torch.float32, self.device, R.Arith(tf32=True))
            tracks_gap = judge.worst(tracks_gap, fits_gap(tracks, m, self.cam, self.device)[0])
        return [("logit_gap", logit_gap), ("mask_gap", mask_gap), ("tracks_gap", tracks_gap)]


def asphalt(image: np.ndarray) -> np.ndarray:
    """The pixels of a frame's round trip that ``frames.render`` painted
    as asphalt: grey, its three channels within ASPHALT_LEVELS of each
    other (grass is 60 or more levels greener than red, the sky 50 bluer
    than green)."""
    c = image.astype(np.int16)
    return (np.abs(c[..., 1] - c[..., 0]) < ASPHALT_LEVELS) & (np.abs(c[..., 2] - c[..., 1]) < ASPHALT_LEVELS)


def decided_gap(drivable: torch.Tensor, want: torch.Tensor, limit: float) -> float:
    """The share of the pixels of the program's (H, W) drivable mask that
    differ from the reference's where the reference's logits, resized
    from ``want`` (C, H / 4, W / 4), decide the pixel's drivable class
    (class 1 against the largest other) by more than twice ``limit``
    times the largest absolute logit of ``want``."""
    full = SegFormer.resize(want.float(), drivable.shape)
    other = torch.cat([full[:1], full[2:]]).amax(dim=0)
    margin = full[1] - other
    decided = torch.abs(margin) > 2.0 * limit * float(torch.abs(want).max())
    wrong = decided & ((margin > 0) != drivable.to(device=full.device).bool())
    return float(wrong.double().mean())


def fits_gap(got: dict, mask: np.ndarray, cam: dict, device) -> tuple[float, int]:
    """The worst metres between a set of track outputs and the plain
    extraction of ``mask`` in float64, and the number of fitted
    polylines judged: the raw limit points valid on both sides,
    MISMATCH_M a point valid on one side only, and each fitted polyline
    (left, right, centre) that the mask determines. A fit is determined
    where the plain extraction's float32 fit lies within DETERMINED_M of
    its float64 fit; a mask of a few rows sets no parabola, and float32
    solves of its near-singular normal equations land anywhere along its
    null space."""
    ref = T.extract(mask, cam, torch.float64, device, R.EXACT)
    low = T.extract(mask, cam, torch.float32, device, R.EXACT)
    worst, judged = 0.0, 0
    for k in ("left_raw", "right_raw"):
        va, vb = got[k + "_mask"].bool(), ref[k + "_mask"].bool()
        worst = judge.worst(worst, MISMATCH_M * float((va != vb).sum()))
        both = va & vb
        if both.any():
            worst = judge.worst(worst, torch.abs(got[k].double()[both] - ref[k][both]).max())
    for k in ("left", "right", "centre"):
        if float(torch.abs(low[k].double() - ref[k]).max()) <= DETERMINED_M:
            worst = judge.worst(worst, torch.abs(got[k].double() - ref[k]).max())
            judged += 1
    return worst, judged


def logit_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference between the program's logits
    (1, h, w, C) and the reference's (C, h, w), over the reference's
    largest absolute logit."""
    gap = torch.abs(got[0].permute(2, 0, 1).double() - want.double()).max()
    return float(gap / torch.abs(want).max().double())
