"""Spatial MPC: waypoints -> speed profile -> linearise -> control QP ->
command extraction.

Counterpart of ``acmpc_tpu/mpc/spatial_mpc.py``. A step is a function
``(MPCState, inputs) -> (MPCState, MPCDiagnostics)``: the carried state
(warm starts, last commands, failure counter) is a dataclass of tensors,
and an infeasible solve keeps serving the previous commands. The batched
step writes its scenario dimension out in front of every tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device, scalar
from acmpc_tpu_torch.dynamics.spatial_bicycle import SpatialBicycleModel, s2t, t2s
from acmpc_tpu_torch.geometry.path import ReferencePath, construct_waypoints
from acmpc_tpu_torch.mpc.control_qp import (
    NU,
    NX,
    assemble_control_qp,
    control_qp_sizes,
)
from acmpc_tpu_torch.ops.graph_loop import GraphCache
from acmpc_tpu_torch.qp.admm import ADMMConfig, QPSolution, _solve_box_qp
from acmpc_tpu_torch.qp.batched import _solve_box_qp_batched
from acmpc_tpu_torch.qp.speed_profile import (
    SpeedProfileConstraints,
    SpeedProfileSolution,
    solve_speed_profile,
    solve_speed_profile_sharded,
)

# iteration cap of the reference controller
MAX_SOLVER_ITERATIONS = 4000


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static per-mode control configuration (racing.control /
    mapping.control blocks of the track YAMLs)."""

    horizon: int
    step_cost: tuple  # (e_y, e_psi, t)
    r_term: tuple  # (velocity, steering)
    final_cost: tuple  # (e_y, e_psi, t)
    constraints: SpeedProfileConstraints
    unlocalised_max_speed: float | None = None
    max_iterations: int = MAX_SOLVER_ITERATIONS
    # real-time-iteration mode: exactly this many ADMM iterations per solve
    rti_iterations: int | None = None

    @classmethod
    def from_config(cls, cfg: dict) -> "MPCConfig":
        return cls(
            horizon=cfg["horizon"],
            step_cost=tuple(cfg["step_cost"]),
            r_term=tuple(cfg["r_term"]),
            final_cost=tuple(cfg["final_cost"]),
            constraints=SpeedProfileConstraints.from_config(
                cfg["speed_profile_constraints"]
            ),
            unlocalised_max_speed=cfg.get("unlocalised_max_speed"),
        )


@dataclasses.dataclass(frozen=True)
class MPCState:
    """Carried solve state; every field may have leading batch dims."""

    projected_control: torch.Tensor  # (..., 2, H-1): [velocities; deltas]
    cum_time: torch.Tensor  # (..., H-1) cumulative time along the horizon
    prediction: torch.Tensor  # (..., H-1, 2) predicted xy
    velocities: torch.Tensor  # (..., H-1) last speed profile
    qp_x: torch.Tensor  # (..., n_var) control-QP primal warm start
    qp_y: torch.Tensor  # (..., n_con) control-QP dual warm start
    infeasibility_counter: torch.Tensor  # (...,) int32
    solved: torch.Tensor  # (...,) bool: last solve succeeded


@dataclasses.dataclass(frozen=True)
class MPCDiagnostics:
    speed_status: torch.Tensor
    speed_iterations: torch.Tensor
    control_status: torch.Tensor
    control_iterations: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor


def _select(ok: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(ok, a, b)`` with ``ok`` of the batch shape and ``a``/``b``
    carrying trailing dims."""
    return torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - ok.dim())), a, b)


def shift_warm_start(state: MPCState, k, horizon: int) -> MPCState:
    """Advance the carried QP warm start by ``k`` reference stages.

    Between steps the window slides along the track with the car, so stage
    j of the new problem is stage j + k of the previous one. The primal
    and dual iterates and the speed warm start are rolled by k stages,
    the vacated tail repeating the terminal stage. ``k`` is an int or one
    per scenario. The published commands and prediction are untouched.
    """
    n = horizon - 1
    k = scalar(k, state.qp_x.device)

    def roll_stages(flat, width, n_stages):
        rows = flat.reshape(*flat.shape[:-1], n_stages, width)
        idx = torch.arange(n_stages, device=flat.device)
        shift = k[..., None] if k.dim() > 0 else k
        src = torch.broadcast_to((idx + shift) % n_stages, rows.shape[:-1])
        rolled = torch.gather(rows, -2, src[..., None].expand(rows.shape))
        keep = torch.broadcast_to(idx < (n_stages - shift), rows.shape[:-1])
        rolled = torch.where(keep[..., None], rolled, rows[..., -1:, :])
        return rolled.reshape(flat.shape)

    nx_all = NX * (n + 1)
    x_states = roll_stages(state.qp_x[..., :nx_all], NX, n + 1)
    x_inputs = roll_stages(state.qp_x[..., nx_all:], NU, n)
    y_eq = roll_stages(state.qp_y[..., :nx_all], NX, n + 1)
    y_box_states = roll_stages(state.qp_y[..., nx_all : 2 * nx_all], NX, n + 1)
    y_box_inputs = roll_stages(state.qp_y[..., 2 * nx_all :], NU, n)
    vels = roll_stages(state.velocities, 1, n)
    return dataclasses.replace(
        state,
        qp_x=torch.cat([x_states, x_inputs], dim=-1),
        qp_y=torch.cat([y_eq, y_box_states, y_box_inputs], dim=-1),
        velocities=vels,
    )


class SpatialMPC:
    """MPC for one (config, model) on one device: ``get_control`` solves
    one scenario; ``batched_get_control`` a batch, each scenario as it
    would be alone; ``batched_get_control_fused`` a batch on the fused,
    fixed-rho engine. ``dtype`` is float32: the port is fp32 throughout
    (its solver chases 1e-3 residuals on fp32 KKT inverses)."""

    def __init__(
        self,
        config: MPCConfig,
        model: SpatialBicycleModel,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        if dtype != torch.float32:
            raise ValueError(f"the port runs the MPC in float32 throughout, not {dtype}")
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        self.dtype = dtype
        # fixed rho and a shorter Ruiz: the warm-started MPC problem family
        # converges without adaptation
        self.admm = ADMMConfig(
            max_iter=config.max_iterations,
            adaptive_rho=False,
            scaling_iters=5,
            fixed_iterations=config.rti_iterations,
        )

    @property
    def horizon(self) -> int:
        return self.config.horizon

    @property
    def delta_max(self) -> float:
        return self.model.delta_max

    def _tensor(self, value, dtype=None) -> torch.Tensor:
        if isinstance(value, np.ndarray) and not value.flags.writeable:
            value = value.copy()  # torch refuses to share read-only memory
        return scalar(value, self.device, dtype or self.dtype)

    def initial_state(self, batch: int | None = None) -> MPCState:
        """Zero carry, unbatched or with a leading scenario dim ``batch``."""
        lead = () if batch is None else (batch,)
        n = self.horizon - 1
        n_var, n_con = control_qp_sizes(self.horizon)

        def zeros(*shape, dtype=None):
            return torch.zeros(
                (*lead, *shape), dtype=dtype or self.dtype, device=self.device
            )

        return MPCState(
            projected_control=zeros(2, n),
            cum_time=zeros(n),
            prediction=zeros(n, 2),
            velocities=zeros(n),
            qp_x=zeros(n_var),
            qp_y=zeros(n_con),
            infeasibility_counter=zeros(dtype=torch.int32),
            solved=zeros(dtype=torch.bool),
        )

    def construct_waypoints(self, waypoint_coordinates) -> ReferencePath:
        return construct_waypoints(self._tensor(waypoint_coordinates))

    def compute_map_speed_profile(
        self,
        path: ReferencePath,
        ay_max: float,
        a_min: float,
        mesh=None,
        axis_name: str | None = None,
    ) -> ReferencePath:
        """Full-track speed profile with map-specific lateral/brake limits;
        keeps the path's velocities where the profile is infeasible.

        With ``mesh`` (a ``parallel.mesh.Mesh``) the map itself is sharded
        over ``axis_name`` (the mesh's first axis by default): each rank
        solves a contiguous slab and the (min,+) block summaries combine
        across ranks (``solve_speed_profile_sharded``); every rank returns
        the whole profile.
        """
        constraints = dataclasses.replace(
            self.config.constraints, ay_max=ay_max, a_min=a_min
        )
        if mesh is not None:
            return self._map_speed_profile_sharded(path, constraints, mesh, axis_name)
        sol = solve_speed_profile(
            path.distances,
            path.kappas,
            constraints,
            v_max_runtime=constraints.v_max,
            localised=False,
            use_end_velocity=False,
        )
        velocities = _select(sol.status == 1, sol.velocities, path.velocities)
        return dataclasses.replace(path, velocities=velocities)

    def _map_speed_profile_sharded(
        self, path: ReferencePath, constraints, mesh, axis_name
    ) -> ReferencePath:
        axis = axis_name or mesh.axis_names[0]
        n_dev = mesh.axis_size(axis)
        n = path.n_points
        pad = (-n) % n_dev
        # neutral padding after the map's end: kappa 0 gives the largest
        # cap, so the backward pass cannot tighten a real waypoint through
        # it; the padded outputs are dropped
        ds = torch.cat([path.distances, torch.ones(pad, dtype=self.dtype, device=path.distances.device)])
        ks = torch.cat([path.kappas, torch.zeros(pad, dtype=self.dtype, device=path.kappas.device)])
        rows = (n + pad) // n_dev
        mine = slice(mesh.axis_index(axis) * rows, (mesh.axis_index(axis) + 1) * rows)
        v_local = solve_speed_profile_sharded(
            ds[mine], ks[mine], constraints, mesh, axis,
            v_max_runtime=constraints.v_max, localised=False, use_end_velocity=False,
        )
        v = mesh.all_gather(v_local, axis).reshape(-1)[:n]
        feasible = torch.all(v >= constraints.v_min - 1e-4)
        return dataclasses.replace(path, velocities=torch.where(feasible, v, path.velocities))

    def _prepare(self, state, reference_path, v_max_runtime, is_localised, offset):
        """Waypoints + speed profile + QP assembly, over any leading batch
        dims of ``reference_path`` (..., H, 3)."""
        cfgc = self.config
        path = self.construct_waypoints(reference_path)
        speed_sol = solve_speed_profile(
            path.distances,
            path.kappas,
            cfgc.constraints,
            v_max_runtime=v_max_runtime,
            localised=is_localised,
            use_end_velocity=True,
        )
        # on speed-profile failure the whole step is gated off in _extract
        path = dataclasses.replace(path, velocities=speed_sol.velocities)

        # initial condition: car at (offset, 0) facing +y in the BEV frame
        offset = self._tensor(offset)
        temporal_state = torch.stack(
            [offset, torch.zeros_like(offset), torch.full_like(offset, math.pi / 2)],
            dim=-1,
        )
        spatial_state = t2s(path.state(0), temporal_state)

        qp = assemble_control_qp(
            path,
            spatial_state,
            self.model,
            cfgc.step_cost,
            cfgc.r_term,
            cfgc.final_cost,
        )
        return path, speed_sol, qp

    def get_control(
        self,
        state: MPCState,
        reference_path,
        v_max_runtime=None,
        is_localised=False,
        offset=0.0,
    ) -> tuple[MPCState, MPCDiagnostics]:
        """One MPC solve for one scenario.

        reference_path: (H, 3) of [x, y, width] in the ego/BEV frame (y
        forward). v_max_runtime: live reference speed. Returns the updated
        carry (the previous commands on an infeasible solve) and
        diagnostics.
        """
        path, speed_sol, qp = self._prepare(
            state, reference_path, v_max_runtime, is_localised, offset
        )
        control_sol = _solve_box_qp(*qp, self.admm, x0=state.qp_x, y0=state.qp_y, box=True)
        return self._extract(state, path, speed_sol, control_sol)

    @functools.cached_property
    def jitted_get_control(self):
        """``get_control`` as a compiled entry: the counterpart of JAX's
        ``jax.jit(get_control)``, with its signature. On the card, the
        first call for an input signature (shapes, dtypes, device)
        captures the whole step as one CUDA graph (``ops/graph_loop``):
        prepare, the factorisation, the QP's chunk loop as one WHILE node
        that the card runs until the residuals pass or ``max_iter``, and
        the extract. Later calls copy the inputs into the graph's buffers,
        replay it and return clones of its outputs: no host read until
        the caller reads a result. Every input (the state's warm starts,
        the reference path, ``v_max_runtime``, ``is_localised``,
        ``offset``) is a device tensor of the graph; a Python number is
        filled on the device. A capture that fails raises. On the CPU
        the step runs eagerly."""
        state_fields = [f.name for f in dataclasses.fields(MPCState)]
        diag_fields = [f.name for f in dataclasses.fields(MPCDiagnostics)]
        n_state = len(state_fields)

        def step(*flat):
            state = MPCState(*flat[:n_state])
            new_state, diags = self.get_control(state, *flat[n_state:])
            return [getattr(new_state, f) for f in state_fields] + [
                getattr(diags, f) for f in diag_fields
            ]

        graphs = GraphCache(step, "SpatialMPC.get_control")

        def jitted_get_control(
            state: MPCState, reference_path, v_max_runtime=None, is_localised=False, offset=0.0
        ) -> tuple[MPCState, MPCDiagnostics]:
            if v_max_runtime is None:
                v_max_runtime = self.config.constraints.v_max
            out = graphs(
                *(getattr(state, f) for f in state_fields),
                self._tensor(reference_path),
                self._tensor(v_max_runtime),
                self._tensor(is_localised, torch.bool),
                self._tensor(offset),
            )
            return MPCState(*out[:n_state]), MPCDiagnostics(*out[n_state:])

        jitted_get_control.graphs = graphs
        return jitted_get_control

    def batched_get_control(
        self,
        states: MPCState,
        refs,
        v_max_runtime=None,
        is_localised=False,
        offset=0.0,
    ) -> tuple[MPCState, MPCDiagnostics]:
        """B scenarios at once, each as ``get_control`` solves it alone:
        the counterpart of ``jit(vmap(get_control))``. ``states`` and
        ``refs`` (B, H, 3) carry a leading scenario axis; the other
        arguments are (B,) or one value for every scenario. The control
        QPs go through the QP engine over the scenario axis (one chunk
        launch for every scenario, each with its own iteration count and
        status; scenarios that are done skip the chunk)."""
        refs = self._tensor(refs)
        B = refs.shape[0]

        def lanes(value, dtype):
            # a Python number is filled on the device: copying it from
            # pageable host memory would wait for the stream to drain
            if isinstance(value, torch.Tensor):
                return torch.broadcast_to(value.to(self.device, dtype), (B,))
            return torch.full((B,), value, dtype=dtype, device=self.device)

        if v_max_runtime is None:
            v_max_runtime = self.config.constraints.v_max
        path, speed_sol, qp = self._prepare(
            states,
            refs,
            lanes(v_max_runtime, self.dtype),
            lanes(is_localised, torch.bool),
            lanes(offset, self.dtype),
        )
        control_sol = _solve_box_qp(*qp, self.admm, x0=states.qp_x, y0=states.qp_y, box=True)
        return self._extract(states, path, speed_sol, control_sol)

    def batched_get_control_fused(
        self, states: MPCState, refs, v_max=None, is_localised=None
    ) -> tuple[MPCState, MPCDiagnostics]:
        """B scenarios at once: batched prepare, the batched QP engine
        (straggler freezing, one kernel launch per chunk for the whole
        batch), batched extract. ``refs`` (B, H, 3); ``v_max`` and
        ``is_localised`` (B,) or None."""
        refs = self._tensor(refs)
        B = refs.shape[0]
        if v_max is None:
            v_max = torch.full(
                (B,), self.config.constraints.v_max, dtype=self.dtype, device=self.device
            )
        if is_localised is None:
            is_localised = torch.zeros((B,), dtype=torch.bool, device=self.device)
        offsets = torch.zeros((B,), dtype=self.dtype, device=self.device)
        path, speed_sol, qp = self._prepare(
            states, refs, self._tensor(v_max), is_localised, offsets
        )
        control_sol = _solve_box_qp_batched(
            *qp, self.admm, x0=states.qp_x, y0=states.qp_y, box=True
        )
        return self._extract(states, path, speed_sol, control_sol)

    def _extract(
        self,
        state: MPCState,
        path: ReferencePath,
        speed_sol: SpeedProfileSolution,
        control_sol: QPSolution,
    ) -> tuple[MPCState, MPCDiagnostics]:
        n = self.horizon - 1
        lead = path.xs.shape[:-1]
        ok = (speed_sol.status == 1) & control_sol.solved

        u_flat = control_sol.x[..., -n * NU :]
        vels = u_flat[..., 0::2]
        deltas = torch.atan(u_flat[..., 1::2] * self.model.length)
        projected = torch.stack([vels, deltas], dim=-2)

        states = control_sol.x[..., : n * NX].reshape(*lead, n, NX)
        prediction = s2t(path, states)[..., :2, :].transpose(-1, -2)
        # the published clock is exact from the solved plan:
        # dt_k = ds_k (1 - kappa_k e_y_k) / v_k
        dt = (
            path.distances
            * (1.0 - path.kappas * states[..., 0])
            / torch.clamp(vels, min=0.1)
        )
        cum_time = torch.cat(
            [torch.zeros_like(dt[..., :1]), torch.cumsum(dt[..., :-1], dim=-1)],
            dim=-1,
        )

        new_state = MPCState(
            projected_control=_select(ok, projected, state.projected_control),
            cum_time=_select(ok, cum_time, state.cum_time),
            prediction=_select(ok, prediction, state.prediction),
            velocities=_select(
                speed_sol.status == 1, speed_sol.velocities, state.velocities
            ),
            # warm starts for the next solve; reset on failure so a bad
            # basin does not persist
            qp_x=_select(ok, control_sol.x, torch.zeros_like(state.qp_x)),
            qp_y=_select(ok, control_sol.y, torch.zeros_like(state.qp_y)),
            infeasibility_counter=torch.where(
                ok, 0, state.infeasibility_counter + 1
            ).to(torch.int32),
            solved=ok,
        )
        diags = MPCDiagnostics(
            speed_status=speed_sol.status,
            speed_iterations=speed_sol.iterations,
            control_status=control_sol.status,
            control_iterations=control_sol.iterations,
            r_prim=control_sol.r_prim,
            r_dual=control_sol.r_dual,
        )
        return new_state, diags


def build_mpc(
    control_config: dict,
    vehicle,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> SpatialMPC:
    """An MPC from a raw control-config dict and VehicleParams."""
    cfg = MPCConfig.from_config(control_config)
    model = SpatialBicycleModel(
        vehicle=vehicle,
        min_velocity=cfg.constraints.v_min,
        max_velocity=cfg.constraints.v_max,
    )
    return SpatialMPC(cfg, model, device, dtype)
