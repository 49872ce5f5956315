"""One car re-solving its MPC every step through the compiled control
entry (``SpatialMPC.jitted_get_control``), closed loop: the car's ego
window of the map goes in, the warm start shifts by the stages the
window moved, the command comes back to the host, and the car is
integrated by it before the next window.

The car and its map are the benchmark's own (``reference/sweep.py``),
started from a seeded point and offset; only the shift and the solve
are the program's, and only they are timed: the car's device work is
waited for before each request starts. Every solve in the window
is judged after it (``judge.qp_ratios``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import judge, program
from perfbench.reference import mpc as R
from perfbench.reference import sweep as S


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.block = config["block"]
        self.ctl = R.Control.from_config(config, self.block)
        self.spans = self.host_spans = None
        self.records: list = []
        self.recording = False

    def setup(self):
        from acmpc_tpu_torch.mpc.spatial_mpc import shift_warm_start

        t = self.traffic
        self.shift = shift_warm_start
        self.mpc = program.build_mpc(self.config, self.block, self.device)
        centre = S.load_centre(t["map"])
        self.step = S.stride(centre, t["window_spacing_m"])
        self.centre = torch.as_tensor(centre, dtype=torch.float32, device=self.device)
        rng = np.random.default_rng(self.seed)
        index = torch.tensor(int(rng.integers(len(centre))), device=self.device)
        offset = float(np.clip(rng.normal(0.0, t["offset_sigma_m"]), -t["offset_clip_m"], t["offset_clip_m"]))
        self.car = S.start(self.centre, index, torch.tensor(offset, device=self.device))
        self.v_cap = float(self.config["agent"][self.block]["control"]["speed_profile_constraints"]["v_max"])
        self.state = self.mpc.initial_state()
        self.prev = S.nearest(self.centre, self.car["x"], self.car["y"])
        for _ in range(t["warm_requests"]):
            self.request()
        self.recording = True

    def request(self) -> float:
        H = self.ctl.horizon
        i0 = S.nearest(self.centre, self.car["x"], self.car["y"])
        ref = S.window(self.centre, self.car["x"], self.car["y"], self.car["yaw"], i0, self.step, H,
                       2.0 * self.traffic["half_width_m"])
        k = S.shift_stages(i0, self.prev, self.centre.shape[0], self.step, H)
        if self.device.type == "cuda":  # the car's own device work ends before the request
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = self.shift(self.state, k, H)
        state, diags = self.mpc.jitted_get_control(state, ref, self.v_cap)
        state.projected_control.cpu()
        t1 = time.perf_counter()
        if self.spans is not None:
            self.spans.setdefault("control", []).append(t1 - t0)
        if self.host_spans is not None:
            self.host_spans.append(("control", t0, t1))
        self.state, self.prev = state, i0
        v, d = S.select(state.cum_time, state.projected_control, self.traffic["dt_s"])
        self.car = S.integrate(self.car, v, d, self.traffic["dt_s"], self.ctl.a_min, self.ctl.a_max,
                               self.ctl.wheelbase)
        if self.recording:
            self.records.append((ref, state, diags))
        return t1 - t0

    def counters(self) -> dict:
        out = program.launch_counts()
        out["requests"] = len(self.records)
        out["qp_solves"] = len(self.records)
        its = [d.control_iterations for _, _, d in self.records]
        out["qp_iterations"] = int(torch.stack(its).sum()) if its else 0
        return out

    def shapes(self) -> dict:
        H = self.ctl.horizon
        n = R.NX * H + R.NU * (H - 1)
        return {"n": n, "m": R.NX * H + n, "batch": 1}

    def _solved(self):
        status = torch.stack([d.control_status for _, _, d in self.records])
        speed = torch.stack([d.speed_status for _, _, d in self.records])
        return ((status == R.STATUS_SOLVED) | (status == R.STATUS_INACCURATE)) & (speed == 1)

    def attempted(self) -> int:
        return len(self.records)

    def failed(self) -> int:
        return int((~self._solved()).sum()) if self.records else 0

    def release(self):
        self.mpc = None

    def check(self) -> list:
        if not self.records:
            return []
        solved = self._solved()
        refs = torch.stack([r for r, _, _ in self.records])[solved]
        states = [s for _, s, _ in self.records]
        pick = lambda f: torch.stack([getattr(s, f) for s in states])[solved]  # noqa: E731
        n = refs.shape[0]
        plan = {"projected": pick("projected_control"), "clock": pick("cum_time"),
                "prediction": pick("prediction")}
        ratios = judge.qp_ratios(refs, torch.full((n,), self.v_cap, device=refs.device),
                                 torch.zeros(n, dtype=torch.bool, device=refs.device),
                                 pick("qp_x"), pick("qp_y"), plan, self.ctl)
        worst = float(ratios.max()) if n else float("inf")
        return [("qp_ratio", worst, self.ctl.inaccurate_factor)]

    def control(self) -> list:
        """The compared numbers of the control (``judge.control_qp_ratios``)
        on a seeded sample of the window's steps."""
        rng = np.random.default_rng(self.seed)
        pick = rng.choice(len(self.records), min(len(self.records), self.traffic["control_steps"]), replace=False)
        refs = torch.stack([self.records[i][0] for i in pick])
        n = refs.shape[0]
        ratios = judge.control_qp_ratios(refs, torch.full((n,), self.v_cap, device=refs.device),
                                         torch.zeros(n, dtype=torch.bool, device=refs.device), self.ctl)
        return [("qp_ratio", float(ratios.max()))]
