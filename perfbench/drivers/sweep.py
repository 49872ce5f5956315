"""B cars closed loop on a map, one batched step a request:
``LapSweep.fused_step`` takes every car's ego window, shifts its warm
start, solves all B control QPs at once (``batched_get_control_fused``)
and integrates each car by its command.

The cars start from seeded draws made with numpy (``draw_grid``): start
points over the whole lap, lateral offsets normal and clipped into the
corridor, speed caps a uniform share of a nominal cap, stratified so
that every seed drives the same set of cars, placed elsewhere. After
the window a seeded sample of the window's steps is judged, every lane
of it, drawn over the whole window as the steps finish (a reservoir of
``check_steps``): the window anchor is the nearest
centreline point, each solved lane's QP answer and plan
(``judge.qp_ratios`` on the window the reference takes itself), and
each car's integration by its published plan.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import judge, program
from perfbench.reference import mpc as R
from perfbench.reference import sweep as S

ANCHOR_M2 = 1e-2


def draw_grid(rng: np.random.Generator, traffic: dict, n_map: int) -> dict:
    """Each car's start index, lateral offset (m) and speed cap (m/s),
    stratified so that every seed sweeps the same set of cars in another
    order: starts evenly spaced over the lap from a seeded phase, offsets
    at the B quantiles of the clipped normal and caps at B even steps of
    their range, each dealt to the cars in a seeded order."""
    from statistics import NormalDist

    B = traffic["batch"]
    lo, hi = traffic["v_cap_scale"]
    clip = traffic["offset_clip_m"]
    mid = (np.arange(B) + 0.5) / B
    offsets = np.array([NormalDist(0.0, traffic["offset_sigma_m"]).inv_cdf(p) for p in mid])
    return {
        "start_index": ((rng.random() + np.arange(B) / B) * n_map).astype(np.int64) % n_map,
        "lateral_offset": np.clip(offsets, -clip, clip)[rng.permutation(B)],
        "v_max": traffic["v_cap_m_s"] * (lo + (hi - lo) * mid)[rng.permutation(B)],
    }


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.block = config["block"]
        self.ctl = R.Control.from_config(config, self.block)
        self.spans = self.host_spans = None
        self.steps = 0
        self.statuses: list = []
        self.iterations: list = []
        self.kept: dict = {}
        self.recording = False

    def setup(self):
        from acmpc_tpu_torch.bench.lap_sweep import LapSweep, SweepGrid
        from acmpc_tpu_torch.localise.track_map import load_track_map

        t = self.traffic
        self.mpc = program.build_mpc(self.config, self.block, self.device)
        self.sweep = LapSweep(self.mpc, load_track_map(t["map"], device=self.device),
                              half_width=t["half_width_m"], dt=t["dt_s"])
        rng = np.random.default_rng(self.seed)
        grid = draw_grid(rng, t, self.sweep._centre.shape[0])
        self.grid = SweepGrid(
            start_index=torch.as_tensor(grid["start_index"], device=self.device),
            lateral_offset=torch.as_tensor(grid["lateral_offset"], dtype=torch.float32, device=self.device),
            v_max=torch.as_tensor(grid["v_max"], dtype=torch.float32, device=self.device),
        )
        self.sweep_stride = self.sweep.window_stride
        self.cars, self.states, self.i0 = self.sweep.start(self.grid)
        self.sample_rng = rng  # the judged steps' reservoir draws
        for _ in range(t["warm_requests"]):
            self.request()
        torch.cuda.synchronize() if self.device.type == "cuda" else None
        self.recording = True

    def request(self) -> float:
        before = (self.cars, self.i0)
        t0 = time.perf_counter()
        cars, states, metrics, i0 = self.sweep.fused_step(self.cars, self.states, self.grid.v_max, self.i0)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if self.spans is not None:
            self.spans.setdefault("step", []).append(t1 - t0)
        if self.host_spans is not None:
            self.host_spans.append(("fused_step", t0, t1))
        self.cars, self.states, self.i0 = cars, states, i0
        if self.recording:
            self.statuses.append(metrics["control_status"])
            self.iterations.append(metrics["control_iterations"])
            self.keep(before, (cars, states, metrics))
            self.steps += 1
        return t1 - t0

    def keep(self, before, after):
        """Reservoir sampling of the judged steps: step k replaces a kept
        one with chance check_steps / (k + 1), so that every step of the
        window is as likely to be judged and memory stays bounded."""
        k, size = self.steps, self.traffic["check_steps"]
        slot = k if k < size else int(self.sample_rng.integers(k + 1))
        if slot < size:
            self.kept[slot] = (before, after)

    def counters(self) -> dict:
        out = program.launch_counts()
        out["requests"] = self.steps
        out["qp_solves"] = self.steps * self.traffic["batch"]
        out["qp_iterations"] = int(torch.stack(self.iterations).sum()) if self.iterations else 0
        return out

    def shapes(self) -> dict:
        H = self.ctl.horizon
        n = R.NX * H + R.NU * (H - 1)
        return {"n": n, "m": R.NX * H + n, "batch": self.traffic["batch"]}

    def _solved(self, status):
        return (status == R.STATUS_SOLVED) | (status == R.STATUS_INACCURATE)

    def solved_count(self) -> int:
        return int(self._solved(torch.stack(self.statuses)).sum()) if self.statuses else 0

    def attempted(self) -> int:
        return self.steps * self.traffic["batch"]

    def failed(self) -> int:
        return self.attempted() - self.solved_count()

    def release(self):
        self.mpc = self.sweep = None

    def check(self) -> list:
        if not self.kept:
            return []
        t, ctl = self.traffic, self.ctl
        centre = torch.as_tensor(S.load_centre(t["map"]), device=self.device)
        step = self.sweep_stride
        worst = 0.0
        for (cars0, _), (cars1, states, metrics) in self.kept.values():
            f64 = {k: getattr(cars0, k).double() for k in ("x", "y", "yaw", "v")}
            i0 = metrics["map_index"]
            # the anchor is a nearest centreline point: within ANCHOR_M2 of
            # the nearest squared distance, what float32 map coordinates
            # of some km leave; another place's point lies far beyond it
            d2 = S.sq_dist(centre, f64["x"], f64["y"])
            gap = torch.gather(d2, -1, i0[:, None])[:, 0] - d2.min(dim=-1).values
            if bool((gap > ANCHOR_M2).any()):
                return [("qp_ratio", float("inf"), ctl.inaccurate_factor)]
            ref = S.window(centre, f64["x"], f64["y"], f64["yaw"], i0, step, ctl.horizon, 2.0 * t["half_width_m"])
            solved = self._solved(metrics["control_status"]) & metrics["solved"]
            plan = {"projected": states.projected_control, "clock": states.cum_time,
                    "prediction": states.prediction}
            ratios = judge.qp_ratios(ref[solved], self.grid.v_max[solved],
                                     torch.zeros(int(solved.sum()), dtype=torch.bool, device=self.device),
                                     states.qp_x[solved], states.qp_y[solved],
                                     {k: v[solved] for k, v in plan.items()}, ctl)
            if len(ratios):
                worst = judge.worst(worst, ratios.max())
            # each car moved by the plan it published: the selection on the
            # program's own clock, the integration in float64; the step's
            # displacement, heading and speed each over the tolerance
            v, d = S.select(states.cum_time, states.projected_control, t["dt_s"])
            moved = S.integrate(f64, v.double(), d.double(), t["dt_s"], ctl.a_min, ctl.a_max, ctl.wheelbase)
            got = {k: getattr(cars1, k).double() for k in ("x", "y", "yaw", "v")}
            for k in ("x", "y"):
                want = moved[k] - f64[k]
                err = torch.abs((got[k] - f64[k]) - want) / (ctl.eps_abs + ctl.eps_rel * torch.abs(want))
                worst = judge.worst(worst, err.max())
            dyaw = torch.remainder(got["yaw"] - moved["yaw"] + np.pi, 2 * np.pi) - np.pi
            worst = judge.worst(worst, (torch.abs(dyaw) / (ctl.eps_abs + ctl.eps_rel * np.pi)).max())
            err = torch.abs(got["v"] - moved["v"]) / (ctl.eps_abs + ctl.eps_rel * torch.abs(moved["v"]))
            worst = judge.worst(worst, err.max())
        return [("qp_ratio", worst, ctl.inaccurate_factor)]

    def control(self) -> list:
        """The compared numbers of the control (``judge.control_qp_ratios``)
        on the first lanes of each judged step."""
        t, ctl, worst = self.traffic, self.ctl, 0.0
        centre = torch.as_tensor(S.load_centre(t["map"]), device=self.device)
        lanes = t["control_lanes"]
        for (cars0, _), (_, _, metrics) in self.kept.values():
            f64 = {k: getattr(cars0, k).double()[:lanes] for k in ("x", "y", "yaw", "v")}
            ref = S.window(centre, f64["x"], f64["y"], f64["yaw"], metrics["map_index"][:lanes],
                           self.sweep_stride, ctl.horizon, 2.0 * t["half_width_m"])
            n = ref.shape[0]
            ratios = judge.control_qp_ratios(ref, self.grid.v_max[:lanes],
                                             torch.zeros(n, dtype=torch.bool, device=self.device), ctl)
            worst = judge.worst(worst, ratios.max())
        return [("qp_ratio", worst)]
