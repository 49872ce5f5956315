"""One car on its camera, closed loop: each request is the racing
agent's path from a host frame to a command on the host.

``Perceiver.perceive`` takes the (H, W, 3) uint8 frame (its JPEG round
trip, the upload and the captured pipeline), the tracks come to the
host as the agent copies them, and the control thread's solve
(``_ControlThread._solve``: the centreline downsampled to the horizon
with tapered widths, the captured MPC step with its state carried from
frame to frame, the command set published to the host) runs in this
thread with no wake-up hand-off. The frames are a pool rendered on the
device at set-up (``frames.py``), fed in order and cycled.

After the window: a seeded sample of the pool's frames, as the program
segmented each on its last pass through the window, is segmented
again by the plain FPN in float32 on the frame's own JPEG round trip
(``mask_gap``, the share of pixels whose drivable class differs), the
program's mask of each goes through the plain extraction (``tracks_gap``,
metres), and every solved step's answer and published plan is judged
against the QP of its window (``qp_ratio``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import frames, judge, program
from perfbench.reference import mpc as R
from perfbench.reference import sweep as S
from perfbench.reference import tracks as T
from perfbench.reference.fpn import FPN, load

# a raw limit point valid on one side only counts as this many metres
MISMATCH_M = 1.0
KEYS = ("left", "right", "centre", "left_raw", "right_raw")


def jpeg_round_trip(image: np.ndarray) -> np.ndarray:
    """The frame as the camera pipeline's JPEG round trip leaves it
    (OpenCV's encoder at its default quality and its decoder): what the
    segmenter is fed, worked out again from the frame."""
    import cv2

    ok, buf = cv2.imencode(".jpg", image)
    if not ok:
        raise RuntimeError("JPEG encoding failed")
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.block = config["block"]
        self.ctl = R.Control.from_config(config, self.block)
        self.cam = config["agent"]["perception"]
        self.spans = self.host_spans = None
        self.records: list = []
        self.kept: dict = {}
        self.recording = False
        self.k = 0

    def setup(self):
        from acmpc_tpu_torch.config.schema import AgentConfig, PerceptionConfig
        from acmpc_tpu_torch.perception.perceiver import Perceiver
        from acmpc_tpu_torch.runtime.controller import Controller, _ControlThread

        t = self.traffic
        agent = self.config["agent"]
        self.perceiver = Perceiver(PerceptionConfig.from_config(agent["perception"]), device=self.device)
        self.controller = Controller(AgentConfig.from_config(agent), device=self.device)
        self.thread = _ControlThread(self.controller)  # solves in this thread; never started
        self.mpc = self.controller.mpc
        rng = np.random.default_rng(self.seed)
        centre = S.load_centre(t["map"])
        rows = frames.poses(centre, rng, t["clips"], t["pool"] // t["clips"], t["frame_step_m"],
                            t["offset_amp_m"], t["yaw_jitter_deg"])
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2 ** 62)))
        self.pool = frames.render(centre, self.cam, rows, t["half_width_m"], gen, self.device)
        self.check_frames = set(int(i) for i in rng.choice(len(self.pool), t["check_frames"], replace=False))
        for _ in range(t["warm_requests"]):
            self.request()
        self.k = 0
        self.recording = True

    def request(self) -> float:
        f = self.k % len(self.pool)
        self.k += 1
        frame = self.pool[f]
        t0 = time.perf_counter()
        out = self.perceiver.perceive(frame)
        if self.spans is not None:
            torch.cuda.synchronize() if self.device.type == "cuda" else None
            t_p = time.perf_counter()
            self.spans.setdefault("perception", []).append(t_p - t0)
        t_c = time.perf_counter()
        tracks = {k: out[n].cpu().numpy() for k, n in (("left", "left"), ("right", "right"), ("centre", "centreline"))}
        t_s = time.perf_counter()
        self.thread._solve(tracks["centre"], 0.0)
        t1 = time.perf_counter()
        if self.spans is not None:
            self.spans.setdefault("control", []).append(t1 - t_s)
        if self.host_spans is not None:
            self.host_spans += [("perceive", t0, t_c), ("tracks_to_host", t_c, t_s), ("control_solve", t_s, t1)]
        if self.recording:
            state = self.thread._states[id(self.mpc)]
            cmds, _, _ = self.controller._command_box.read()
            self.records.append((tracks["centre"], state, cmds if bool(state.solved) else None))
            if f in self.check_frames:  # the frame's last pass in the window
                self.kept[f] = {"drivable": out["drivable"],
                                **{k: out[k] for k in ("left_raw", "left_raw_mask", "right_raw", "right_raw_mask")},
                                "left": out["left"], "right": out["right"], "centre": out["centreline"]}
        return t1 - t0

    def counters(self) -> dict:
        out = program.launch_counts()
        n = len(self.records)
        out.update(requests=n, qp_solves=n, frames=n, qp_iterations=25 * out["chunks"])
        return out

    def shapes(self) -> dict:
        H = self.ctl.horizon
        n = R.NX * H + R.NU * (H - 1)
        return {"n": n, "m": R.NX * H + n, "batch": 1}

    def frame_shape(self) -> tuple:
        return self.cam["image_height"], self.cam["image_width"]

    def attempted(self) -> int:
        return len(self.records)

    def failed(self) -> int:
        return sum(1 for r in self.records if r[2] is None)

    def release(self):
        self.perceiver = self.controller = self.thread = self.mpc = None

    def windows(self):
        """The solve's (H, 3) window of each centreline, as the control
        thread makes it: every len/H-th point, the last repeated to H,
        widths 10 m to 6 m."""
        H = self.ctl.horizon
        out = []
        for centre, _, _ in self.records:
            ds = max(1, int(len(centre) / H))
            pts = centre[::ds][:H]
            if len(pts) < H:
                pts = np.concatenate([pts, np.repeat(pts[-1:], H - len(pts), axis=0)])
            out.append(np.stack([pts[:, 0], pts[:, 1], np.linspace(10.0, 6.0, H)]).T.astype(np.float32))
        return np.stack(out)

    def check(self) -> list:
        if not self.records:
            return []
        dev = self.device
        # the control step of every solved request
        solved = [i for i, r in enumerate(self.records) if r[2] is not None]
        qp = float("inf")
        if solved:
            win = torch.as_tensor(self.windows()[solved], device=dev)
            st = [self.records[i][1] for i in solved]
            cm = [self.records[i][2] for i in solved]
            plan = {"projected": torch.as_tensor(np.stack([c.controls.T for c in cm]), device=dev),
                    "clock": torch.as_tensor(np.stack([c.cum_time for c in cm]), device=dev),
                    "prediction": torch.as_tensor(np.stack([c.prediction for c in cm]), device=dev)}
            n = len(solved)
            v_cap = self.config["agent"][self.block]["control"].get("unlocalised_max_speed") or self.ctl.v_max
            ratios = judge.qp_ratios(win, torch.full((n,), float(v_cap), device=dev),
                                     torch.zeros(n, dtype=torch.bool, device=dev),
                                     torch.stack([s.qp_x for s in st]), torch.stack([s.qp_y for s in st]),
                                     plan, self.ctl)
            qp = float(ratios.max())
        mask_gap, tracks_gap = self.perception_gaps(FPN(load(self.cam["model_path"], dev)), R.EXACT)
        return [("mask_gap", mask_gap, self.traffic["mask_gap_limit"]),
                ("tracks_gap", tracks_gap, self.traffic["tracks_gap_limit"]),
                ("qp_ratio", qp, self.ctl.inaccurate_factor)]

    def perception_gaps(self, fpn: FPN, ar) -> tuple[float, float]:
        """The worst share of differing mask pixels against ``fpn`` on the
        frame's JPEG round trip, and the worst metres between the
        program's tracks and the plain extraction of its own mask."""
        mask_gap = tracks_gap = 0.0
        dtype = torch.float64 if not ar.tf32 else torch.float32
        for f, got in self.kept.items():
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            want = fpn.drivable(image)
            mask_gap = judge.worst(mask_gap, (want != got["drivable"]).float().mean())
            ref = T.extract(got["drivable"].cpu().numpy(), self.cam, dtype, self.device, ar)
            tracks_gap = judge.worst(tracks_gap, tracks_distance(got, ref))
        return mask_gap, tracks_gap


    def control(self) -> list:
        """The compared numbers of the control: the FPN with float8 e4m3
        convolutions, the extraction with TF32 products on the control's
        own mask, the reference's TF32 step on a seeded sample of windows
        (``judge.control_qp_ratios``)."""
        ref_fpn = FPN(load(self.cam["model_path"], self.device))
        low_fpn = FPN(load(self.cam["model_path"], self.device), fp8=True)
        mask_gap = tracks_gap = 0.0
        for f in self.kept:
            image = torch.as_tensor(jpeg_round_trip(self.pool[f]), device=self.device)
            low = low_fpn.drivable(image)
            mask_gap = judge.worst(mask_gap, (low != ref_fpn.drivable(image)).float().mean())
            m = low.cpu().numpy()
            got = T.extract(m, self.cam, torch.float32, self.device, R.Arith(tf32=True))
            got["drivable"] = low
            tracks_gap = judge.worst(tracks_gap, tracks_distance(got, T.extract(m, self.cam, torch.float64, self.device)))
        rng = np.random.default_rng(self.seed)
        win = self.windows()
        pick = rng.choice(len(win), min(len(win), self.traffic["control_steps"]), replace=False)
        win = torch.as_tensor(win[pick], device=self.device)
        n = win.shape[0]
        v_cap = self.config["agent"][self.block]["control"].get("unlocalised_max_speed") or self.ctl.v_max
        ratios = judge.control_qp_ratios(win, torch.full((n,), float(v_cap), device=self.device),
                                         torch.zeros(n, dtype=torch.bool, device=self.device), self.ctl)
        return [("mask_gap", mask_gap), ("tracks_gap", tracks_gap), ("qp_ratio", float(ratios.max()))]


def tracks_distance(got: dict, ref: dict) -> float:
    """The worst metres between two sets of track outputs: the fitted
    limits and centreline point by point, the raw limit points valid on
    both sides, and MISMATCH_M a point valid on one side only."""
    worst = 0.0
    for k in KEYS:
        a, b = got[k].double(), ref[k].double()
        if k.endswith("_raw"):
            va, vb = got[k + "_mask"].bool(), ref[k + "_mask"].bool()
            worst = judge.worst(worst, MISMATCH_M * float((va != vb).sum()))
            both = va & vb
            a, b = a[both], b[both]
        if len(a):
            worst = judge.worst(worst, torch.abs(a - b).max())
    return worst

