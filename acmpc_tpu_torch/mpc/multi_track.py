"""All-tracks MPC: one batched solve across track configs.

Counterpart of ``acmpc_tpu/mpc/multi_track.py``. The racing configs of
the seven shipped tracks share the horizon and the vehicle and differ
only in VALUES: cost weights and speed-profile constraints. So the track
axis becomes the batch of the batched QP engine: the per-track values
enter as (B, ...) tensors, and each iteration chunk is one kernel launch
for every track at once. A (scenario, track) grid flattens to a batch of
S * T the same way.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acmpc_tpu_torch.dynamics.spatial_bicycle import t2s
from acmpc_tpu_torch.geometry.path import construct_waypoints
from acmpc_tpu_torch.mpc.control_qp import assemble_control_qp
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig, MPCDiagnostics, MPCState, SpatialMPC
from acmpc_tpu_torch.qp.admm import STATUS_MAX_ITER, STATUS_SOLVED
from acmpc_tpu_torch.qp.batched import _solve_box_qp_batched
from acmpc_tpu_torch.qp.speed_profile import SpeedProfileSolution, _min_plus_scan

_EPS = 1e-12


def pack_track_params(
    configs: list[MPCConfig], device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Stack per-track cost and constraint values into fp32 tensors:
    (T, 3) costs, (T, 2) ``r_term``, (T,) constraints. An ``end_velocity``
    of None (vallelunga) becomes ``has_end_velocity`` 0."""
    c = [cfg.constraints for cfg in configs]

    def stack(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    return {
        "step_cost": stack([cfg.step_cost for cfg in configs]),
        "r_term": stack([cfg.r_term for cfg in configs]),
        "final_cost": stack([cfg.final_cost for cfg in configs]),
        "v_min": stack([x.v_min for x in c]),
        "v_max": stack([x.v_max for x in c]),
        "a_min": stack([x.a_min for x in c]),
        "a_max": stack([x.a_max for x in c]),
        "ay_max": stack([x.ay_max for x in c]),
        "ki_min": stack([x.ki_min for x in c]),
        "end_velocity": stack(
            [x.end_velocity if x.end_velocity is not None else 0.0 for x in c]
        ),
        "has_end_velocity": stack([float(x.end_velocity is not None) for x in c]),
    }


def _speed_profile_traced(distances, kappas, p, v_max_runtime) -> SpeedProfileSolution:
    """Exact (min,+)-scan speed solve with per-scenario constraint values:
    ``distances``/``kappas`` (B, N), every ``p`` entry and
    ``v_max_runtime`` (B,). The order of operations is the JAX package's:
    the cap floored at v_min plus 2, then the end velocity where set."""
    def col(v):
        return v[..., None]

    abs_k = torch.abs(kappas)
    v_run = col(v_max_runtime)
    v_max_dyn = torch.sqrt(col(p["ay_max"]) / (abs_k + _EPS))
    v_max_dyn = torch.where(abs_k < col(p["ki_min"]), v_run, v_max_dyn)
    v_caps = torch.minimum(v_max_dyn, v_run)
    v_caps = torch.maximum(col(p["v_min"]), v_caps) + 2.0
    end = torch.where(
        col(p["has_end_velocity"]) > 0, col(p["end_velocity"]), v_caps[..., -1:]
    )
    v_hi = torch.cat([v_caps[..., :-1], end], dim=-1)

    n = kappas.shape[-1]
    d = distances[..., : n - 1]
    forward = _min_plus_scan(v_hi, 2.0 * d * col(p["a_max"]))
    backward = torch.flip(
        _min_plus_scan(
            torch.flip(v_hi, [-1]), torch.flip(-2.0 * d * col(p["a_min"]), [-1])
        ),
        [-1],
    )
    v = torch.minimum(forward, backward)
    feasible = torch.all(v >= col(p["v_min"]) - 1e-4, dim=-1)
    status = torch.where(feasible, STATUS_SOLVED, STATUS_MAX_ITER).to(torch.int32)
    zero = torch.zeros_like(v[..., 0])
    return SpeedProfileSolution(
        velocities=v,
        status=status,
        iterations=torch.zeros_like(status),
        r_prim=zero,
        r_dual=zero,
    )


def _flatten(tree, lead: int):
    """Merge the first ``lead`` dims of every tensor field into one."""
    return dataclasses.replace(
        tree,
        **{
            f.name: getattr(tree, f.name).flatten(0, lead - 1)
            for f in dataclasses.fields(tree)
        },
    )


def _unflatten(tree, shape):
    return dataclasses.replace(
        tree,
        **{
            f.name: getattr(tree, f.name).unflatten(0, shape)
            for f in dataclasses.fields(tree)
        },
    )


class MultiTrackMPC:
    """One SpatialMPC template (shared horizon, vehicle, device) solving a
    batch of per-track parameterisations in one batched step."""

    def __init__(self, template: SpatialMPC, configs: list[MPCConfig]):
        horizons = {cfg.horizon for cfg in configs}
        if horizons != {template.horizon}:
            raise ValueError(
                f"all tracks must share the template horizon, got {horizons}"
            )
        self.mpc = template
        self.params = pack_track_params(configs, template.device)
        self.n_tracks = len(configs)

    def _solve(self, states: MPCState, refs, p, v_max_runtime):
        """The batched step over B = leading dim of every argument."""
        mpc = self.mpc
        path = mpc.construct_waypoints(refs)
        speed_sol = _speed_profile_traced(path.distances, path.kappas, p, v_max_runtime)
        path = dataclasses.replace(path, velocities=speed_sol.velocities)
        temporal = torch.tensor([0.0, 0.0, math.pi / 2], dtype=mpc.dtype, device=mpc.device)
        spatial_state = t2s(path.state(0), temporal)
        kappa_max = torch.full_like(p["v_min"], mpc.model.kappa_max)
        qp = assemble_control_qp(
            path,
            spatial_state,
            mpc.model,
            p["step_cost"],
            p["r_term"],
            p["final_cost"],
            u_min=torch.stack([p["v_min"], -kappa_max], dim=-1),
            u_max=torch.stack([p["v_max"], kappa_max], dim=-1),
        )
        sol = _solve_box_qp_batched(*qp, mpc.admm, x0=states.qp_x, y0=states.qp_y, box=True)
        return mpc._extract(states, path, speed_sol, sol)

    def get_control(
        self, states: MPCState, refs, v_max_runtime=None
    ) -> tuple[MPCState, MPCDiagnostics]:
        """``states``/``refs`` lead with the track axis (T, ...);
        ``v_max_runtime`` (T,) or None for each track's configured cap."""
        if v_max_runtime is None:
            v_max_runtime = self.params["v_max"]
        return self._solve(
            states, self.mpc._tensor(refs), self.params, self.mpc._tensor(v_max_runtime)
        )

    def get_control_grid(
        self, states: MPCState, refs, v_max_runtime=None
    ) -> tuple[MPCState, MPCDiagnostics]:
        """Track x scenario grid: ``states``/``refs`` lead with (S, T, ...),
        ``v_max_runtime`` (S, T) or None. One batched step of S * T."""
        refs = self.mpc._tensor(refs)
        S, T = refs.shape[:2]
        if v_max_runtime is None:
            v_max_runtime = self.params["v_max"].expand(S, T)
        params = {k: v.expand(S, *v.shape).flatten(0, 1) for k, v in self.params.items()}
        new, diags = self._solve(
            _flatten(states, 2),
            refs.flatten(0, 1),
            params,
            self.mpc._tensor(v_max_runtime).flatten(0, 1),
        )
        return _unflatten(new, (S, T)), _unflatten(diags, (S, T))

    def initial_states(self, n_scenarios: int | None = None) -> MPCState:
        """Zero carry with a leading track axis, or (S, T) with
        ``n_scenarios``."""
        states = self.mpc.initial_state(self.n_tracks)
        if n_scenarios is None:
            return states
        fields = {f.name: getattr(states, f.name) for f in dataclasses.fields(states)}
        return MPCState(
            **{k: v.expand(n_scenarios, *v.shape).clone() for k, v in fields.items()}
        )
