"""Closed-loop lap sweeps on the device.

Counterpart of ``acmpc_tpu/bench/lap_sweep.py``. Per step, each scenario
takes its own map window in the ego frame, the batched MPC solves every
scenario at once, each car samples its active command and a kinematic
bicycle integrates it. The scenario axis is written out in front of
every tensor. ``run`` solves each step with ``batched_get_control``
(every scenario as it would be alone), ``run_fused`` with the fused,
fixed-rho engine. ``run`` dispatches each step from the host and reads
back the solve's chunk flags; ``fused_step``, on the card, is one CUDA
graph a step, its chunk loop a WHILE node, and reads nothing back.

The per-scenario runtime knobs (start index, lateral offset, runtime
speed cap) are the perturbation axes of the robustness sweeps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.geometry.path import wrap_to_pi
from acmpc_tpu_torch.localise.track_map import TrackMap
from acmpc_tpu_torch.mpc.spatial_mpc import MPCState, SpatialMPC, shift_warm_start
from acmpc_tpu_torch.ops.graph_loop import GraphCache
from acmpc_tpu_torch.utils.monitor import MONITOR


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """Per-scenario perturbations (leading dim = scenario)."""

    start_index: torch.Tensor  # int64 (B,)
    lateral_offset: torch.Tensor  # (B,) metres
    v_max: torch.Tensor  # (B,) runtime speed cap

    @classmethod
    def regular(
        cls, batch: int, n_map_points: int, v_max: float = 28.0, device=None
    ) -> "SweepGrid":
        device = resolve_device(device)
        return cls(
            start_index=torch.linspace(0, n_map_points - 1, batch, device=device).long(),
            lateral_offset=torch.zeros(batch, device=device),
            v_max=torch.full((batch,), v_max, device=device),
        )

    @classmethod
    def perturbed(
        cls,
        generator: torch.Generator,
        batch: int,
        n_map_points: int,
        v_max: float = 28.0,
    ) -> "SweepGrid":
        """Random starts, lateral offsets and caps from ``generator``, on
        the generator's device. Its draws are not ``jax.random``'s: build
        the grid with numpy where two packages must see the same one."""
        g = generator
        device = g.device
        return cls(
            start_index=torch.randint(0, n_map_points, (batch,), generator=g, device=device),
            # clipped into the drivable corridor: starts outside it are
            # unrecoverable by construction
            lateral_offset=torch.clamp(
                1.5 * torch.randn(batch, generator=g, device=device), -3.0, 3.0
            ),
            v_max=v_max * (0.8 + 0.3 * torch.rand(batch, generator=g, device=device)),
        )


@dataclasses.dataclass(frozen=True)
class CarState:
    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor
    v: torch.Tensor


# the compiled step's flat inputs and outputs: the cars' and the states'
# fields, then the step's metrics in the order the eager step makes them
_CAR_FIELDS = tuple(f.name for f in dataclasses.fields(CarState))
_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(MPCState))
_METRICS = ("v", "offtrack", "solved", "map_index", "control_iterations", "control_status")


class LapSweep:
    """Closed-loop lap simulation for one (mpc, map) pair, on the MPC's
    device. The per-step pieces take any leading scenario dims."""

    def __init__(
        self,
        mpc: SpatialMPC,
        track_map: TrackMap,
        half_width: float = 5.0,
        dt: float = 0.1,
        window_spacing: float = 2.0,
        reference_polyline: np.ndarray | None = None,
        reference_widths: np.ndarray | None = None,
        reference_speeds: np.ndarray | None = None,
    ):
        """``reference_polyline`` switches the TRACKED line away from the
        map centreline, e.g. to the shipped minimum-curvature raceline;
        ``reference_widths`` gives the drivable corridor width at each of
        its points. The off-track metric always measures against the map
        centreline.

        ``reference_speeds`` is a per-point speed profile (the shipped
        ``data/racelines/*.npz`` "speeds"): when given, each step's
        runtime cap is the windowed mean of the profile from 12.5 m behind
        the car to 37.5 m ahead, and the speed profile runs in localised
        mode (no curvature cap: the map speeds already encode it)."""
        self.mpc = mpc
        self.map = track_map
        self.half_width = half_width
        self.dt = dt
        device, dtype = mpc.device, mpc.dtype
        centre = track_map.centre.detach().cpu().numpy()
        ref = centre if reference_polyline is None else np.asarray(reference_polyline)
        spacing = float(np.linalg.norm(np.diff(ref, axis=0), axis=1).mean())
        self.window_stride = max(1, int(round(window_spacing / spacing)))
        self._map_centre = torch.as_tensor(centre, dtype=dtype, device=device)
        self._centre = torch.as_tensor(ref, dtype=dtype, device=device)
        if reference_widths is None:
            widths = np.full(len(ref), 2.0 * half_width, np.float32)
        else:
            widths = np.asarray(reference_widths, np.float32)
        self._widths = torch.as_tensor(widths, dtype=dtype, device=device)
        if reference_speeds is None:
            self._speeds = None
        else:
            # the (N-1,) per-segment profile, repeated to the N points
            speeds = np.resize(np.asarray(reference_speeds, np.float32), len(ref))
            self._speeds = torch.as_tensor(speeds, dtype=dtype, device=device)
            self._speed_window = torch.arange(
                -max(1, int(round(12.5 / spacing))),
                max(1, int(round(37.5 / spacing))),
                device=device,
            )
        self._fused_graphs = GraphCache(self._fused_flat, "LapSweep.fused_step")

    def _runtime_v_max(self, grid_v_max, i0):
        """Per-step speed cap: the grid's cap, gated by the windowed mean
        of the speed profile when one is loaded."""
        if self._speeds is None:
            return grid_v_max
        m = self._speeds.shape[0]
        idx = torch.remainder(i0[..., None] + self._speed_window, m)
        return torch.minimum(grid_v_max, torch.mean(self._speeds[idx], dim=-1))

    # -- per-step pieces (any leading scenario dims) ----------------------
    def _init_car(self, grid: SweepGrid) -> CarState:
        centre = self._centre
        m = centre.shape[0]
        idx = grid.start_index
        p0 = centre[torch.remainder(idx, m)]
        p1 = centre[torch.remainder(idx + 1, m)]
        yaw = torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
        normal = torch.stack([-torch.sin(yaw), torch.cos(yaw)], dim=-1)  # left
        pos = p0 + grid.lateral_offset[..., None] * normal
        return CarState(x=pos[..., 0], y=pos[..., 1], yaw=yaw, v=torch.full_like(yaw, 10.0))

    @staticmethod
    def _sq_dist(polyline: torch.Tensor, car: CarState) -> torch.Tensor:
        """Squared distance (..., M) from each car to every point."""
        dx = polyline[:, 0] - car.x[..., None]
        dy = polyline[:, 1] - car.y[..., None]
        return dx * dx + dy * dy

    def _ego_window(self, car: CarState):
        """Reference window ahead of the car, in the ego BEV frame (y
        forward): (..., H, 3) of [x, y, width], and the nearest reference
        index i0 (...,)."""
        centre = self._centre
        m = centre.shape[0]
        i0 = torch.argmin(self._sq_dist(centre, car), dim=-1)
        steps = self.window_stride * torch.arange(self.mpc.horizon, device=centre.device)
        idx = torch.remainder(i0[..., None] + steps, m)
        world = centre[idx]
        dx = world[..., 0] - car.x[..., None]
        dy = world[..., 1] - car.y[..., None]
        a = (-car.yaw + math.pi / 2)[..., None]
        cos_a, sin_a = torch.cos(a), torch.sin(a)
        bev_x = dx * cos_a - dy * sin_a
        bev_y = dx * sin_a + dy * cos_a
        return torch.stack([bev_x, bev_y, self._widths[idx]], dim=-1), i0

    @staticmethod
    def _select_command(mpc_state: MPCState, elapsed: float):
        """The command active ``elapsed`` seconds after the solve
        (``runtime/commands.py::TemporalCommandSelector`` on the device,
        with the step back from index 0 clipped to 0)."""
        cum = mpc_state.cum_time
        dist = cum - elapsed
        i = torch.argmin(torch.abs(dist), dim=-1, keepdim=True)
        i = torch.where(torch.gather(dist, -1, i) > 0, i - 1, i)
        i = torch.clamp(i, 0, cum.shape[-1] - 1)
        pc = mpc_state.projected_control
        v_cmd = torch.gather(pc[..., 0, :], -1, i)[..., 0]
        delta_cmd = torch.gather(pc[..., 1, :], -1, i)[..., 0]
        return v_cmd, delta_cmd

    def _integrate(self, car: CarState, mpc_state: MPCState, i0):
        """Apply the active command through the kinematic car; returns
        the new car and the step's metrics."""
        v_cmd, delta = self._select_command(mpc_state, self.dt)
        # longitudinal response limited by the configured accel band
        c = self.mpc.config.constraints
        dv = torch.clamp(v_cmd - car.v, c.a_min * 3 * self.dt, c.a_max * 3 * self.dt)
        v = torch.clamp(car.v + dv, min=0.0)
        yaw = wrap_to_pi(car.yaw + v * torch.tan(delta) / self.mpc.model.length * self.dt)
        car = CarState(
            x=car.x + v * torch.cos(car.yaw) * self.dt,
            y=car.y + v * torch.sin(car.yaw) * self.dt,
            yaw=yaw,
            v=v,
        )
        off = torch.sqrt(torch.amin(self._sq_dist(self._map_centre, car), dim=-1))
        metrics = {
            "v": v,
            "offtrack": off,
            "solved": mpc_state.solved,
            "map_index": i0,
        }
        return car, metrics

    def _shift_stages(self, i0, prev_i0):
        """Reference stages the window advanced since the last solve. A
        nearest-index regression (the argmin slipping back a point) wraps
        to ~m-1 under the modulo; any backward jump counts as no shift."""
        m = self._centre.shape[0]
        delta = torch.remainder(i0 - prev_i0, m)
        delta = torch.where(delta > m // 2, 0, delta)
        k = torch.round(delta / self.window_stride).to(torch.int32)
        return torch.clamp(k, 0, self.mpc.horizon - 1)

    # -- public API --------------------------------------------------------
    def start(self, grid: SweepGrid):
        """(cars, zero MPC states, nearest indices) before the first
        step; the first step shifts no warm start."""
        cars = self._init_car(grid)
        states = self.mpc.initial_state(grid.start_index.shape[0])
        _, i0 = self._ego_window(cars)
        return cars, states, i0

    def _step(self, cars: CarState, states: MPCState, v_max, prev_i0, get_control):
        """One closed-loop step of every scenario: windows, the shifted
        warm start (real-time iteration: the carried iterates advance by
        the stages each window slid), one batched MPC solve through
        ``get_control``, integration. Returns (cars, states, metrics, i0).
        The caller opens its ``sweep.step`` span."""
        device = self._centre.device
        with MONITOR.device_span("sweep.window", device):
            refs, i0 = self._ego_window(cars)
            k = self._shift_stages(i0, prev_i0)
            localised = torch.full(i0.shape, self._speeds is not None, device=i0.device)
            v_max = self._runtime_v_max(v_max, i0)
        states = shift_warm_start(states, k, self.mpc.horizon)
        states, diags = get_control(states, refs, v_max, is_localised=localised)
        with MONITOR.device_span("sweep.integrate", device):
            cars, metrics = self._integrate(cars, states, i0)
        metrics["control_iterations"] = diags.control_iterations
        metrics["control_status"] = diags.control_status
        return cars, states, metrics, i0

    def _fused_flat(self, *flat):
        """The fused step over flat tensors, the function that
        :meth:`fused_step` captures: the cars' fields, the states',
        ``v_max`` and ``prev_i0`` in; the cars', the states', the
        metrics (``_METRICS``) and ``i0`` out. The MPC's entry is looked
        up at each call, so that a replacement of it takes effect where
        the step runs eagerly."""
        n_car, n_state = len(_CAR_FIELDS), len(_STATE_FIELDS)
        cars = CarState(*flat[:n_car])
        states = MPCState(*flat[n_car : n_car + n_state])
        v_max, prev_i0 = flat[n_car + n_state :]
        cars, states, metrics, i0 = self._step(
            cars, states, v_max, prev_i0, self.mpc.batched_get_control_fused
        )
        return [
            *(getattr(cars, f) for f in _CAR_FIELDS),
            *(getattr(states, f) for f in _STATE_FIELDS),
            *(metrics[k] for k in _METRICS),
            i0,
        ]

    def fused_step(self, cars: CarState, states: MPCState, v_max, prev_i0):
        """One closed-loop step (:meth:`_step`) on the fused, fixed-rho engine
        (``batched_get_control_fused``), as a compiled entry. On the card,
        the first call for an input signature (the batch) captures the
        whole step as one CUDA graph (``ops/graph_loop``): the windows,
        the shifted warm starts, the batched prepare, scaling and
        factorisation, the chunk loop as one WHILE node, the extract and
        the integration. Later calls copy the inputs into the graph's
        buffers, replay it and return clones of its outputs, with no host
        read. A capture that fails raises. On the CPU the step runs
        eagerly."""
        n_car, n_state = len(_CAR_FIELDS), len(_STATE_FIELDS)
        with MONITOR.span("sweep.step"):
            out = self._fused_graphs(
                *(getattr(cars, f) for f in _CAR_FIELDS),
                *(getattr(states, f) for f in _STATE_FIELDS),
                v_max,
                prev_i0,
            )
        metrics = dict(zip(_METRICS, out[n_car + n_state : -1]))
        return CarState(*out[:n_car]), MPCState(*out[n_car : n_car + n_state]), metrics, out[-1]

    def _run(self, grid: SweepGrid, n_steps: int, step):
        cars, states, prev_i0 = self.start(grid)
        per_step = []
        for _ in range(n_steps):
            cars, states, metrics, prev_i0 = step(cars, states, grid.v_max, prev_i0)
            per_step.append(metrics)
        return cars, _stack_steps(per_step)

    def run_fused(self, grid: SweepGrid, n_steps: int):
        """Closed-loop sweep with the whole scenario batch in each step,
        each step one :meth:`fused_step`. Returns (final cars, metrics
        stacked (B, n_steps))."""
        return self._run(grid, n_steps, self.fused_step)

    def run(self, grid: SweepGrid, n_steps: int):
        """Closed-loop sweep of every scenario, each step one
        ``batched_get_control`` (every scenario solved as it would be
        alone): the counterpart of the JAX package's ``jit(vmap(scenario))``
        of a scan. Returns (final cars (B,), metrics stacked
        (B, n_steps))."""

        def step(cars, states, v_max, prev_i0):
            with MONITOR.span("sweep.step"):
                return self._step(cars, states, v_max, prev_i0, self.mpc.batched_get_control)

        return self._run(grid, n_steps, step)

    def summarise(self, metrics, n_steps: int) -> dict:
        v = _host(metrics["v"])
        off = _host(metrics["offtrack"])
        solved = _host(metrics["solved"])
        out = {
            "scenarios": int(v.shape[0]),
            "steps": int(n_steps),
            "total_solves": int(v.shape[0] * n_steps),
            "mean_speed_ms": float(v[:, n_steps // 4 :].mean()),
            "p95_offtrack_m": float(np.percentile(off, 95)),
            "solve_success_rate": float(solved.mean()),
        }
        # failures by QP status (qp/admm.py STATUS_*): infeasibility
        # certificates against an exhausted iteration budget, and whether
        # a scenario recovers on a later step
        if "control_status" in metrics:
            status = _host(metrics["control_status"])
            fails = ~solved.astype(bool)
            n = max(int(fails.sum()), 1)
            persistent = fails[:, -1] & (fails.sum(axis=1) > n_steps // 2)
            out.update(
                fail_max_iter_frac=float((fails & (status == 0)).sum() / n),
                fail_primal_infeasible_frac=float((fails & (status == 2)).sum() / n),
                fail_persistent_scenarios=int(persistent.sum()),
            )
        # a car outside the drivable corridor (|e_y| > width/2 - margin,
        # the QP's box on e_y) makes the QP genuinely infeasible, so
        # failures inside the corridor are reported on their own
        half_drivable = self.half_width - self.mpc.model.margin
        in_corridor = off <= half_drivable
        fails = ~solved.astype(bool)
        out.update(
            crashed_scenarios=int((~in_corridor).any(axis=1).sum()),
            in_corridor_fail_rate=float(
                (fails & in_corridor).sum() / max(in_corridor.sum(), 1)
            ),
        )
        return out


def _stack_steps(per_step: list[dict]) -> dict:
    """Per-step metric dicts of (B,) tensors -> one dict of (B, n_steps)."""
    return {k: torch.stack([m[k] for m in per_step], dim=1) for k in per_step[0]}


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)
