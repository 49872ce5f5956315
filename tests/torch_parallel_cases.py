"""The rank side of the port's multi-process tests (test_torch_parallel.py,
test_torch_tridiag.py): one process per rank, gloo on the CPU, a file
store for the rendezvous. Imports no JAX.

    python tests/torch_parallel_cases.py <dir> <world> <rank>

reads ``<dir>/inputs.npz`` (global numpy inputs, keys ``<case>/<name>``),
runs every case that has inputs there on this rank's share of them, and
writes ``<dir>/rank<rank>.npz`` (keys ``<case>/<name>``).
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from acmpc_tpu_torch.bench.lap_sweep import LapSweep  # noqa: E402
from acmpc_tpu_torch.bench.pod_sweep import PROFILE_MAPS, profile_path  # noqa: E402
from acmpc_tpu_torch.cli.launch_pod import racing_mpc  # noqa: E402
from acmpc_tpu_torch.config import load_config  # noqa: E402
from acmpc_tpu_torch.convert import sweep_grid_from_numpy, track_map_from_numpy  # noqa: E402
from acmpc_tpu_torch.dynamics import SpatialBicycleModel, VehicleParams  # noqa: E402
from acmpc_tpu_torch.geometry.path import construct_waypoints  # noqa: E402
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig, SpatialMPC  # noqa: E402
from acmpc_tpu_torch.ops.tridiag_sharded import tridiag_solve_sharded  # noqa: E402
from acmpc_tpu_torch.parallel import make_mesh, scenario_sharding, sharded_get_control  # noqa: E402
from acmpc_tpu_torch.parallel.mesh import replicate_state  # noqa: E402
from acmpc_tpu_torch.parallel.multihost import (  # noqa: E402
    grid_sharding,
    initialize_distributed,
    make_pod_mesh,
    put_global,
    sharded_full_lap,
    sharded_lap_sweep,
)
from acmpc_tpu_torch.qp.admm import ADMMConfig  # noqa: E402
from acmpc_tpu_torch.qp.speed_profile import (  # noqa: E402
    SpeedProfileConstraints,
    solve_speed_profile_admm_sharded,
    solve_speed_profile_sharded,
)

# tests/test_horizon_sharded.py's and tests/test_parallel.py's settings
CONS = dict(v_min=5.0, v_max=30.0, a_min=-3.0, a_max=6.0, ay_max=5.5, ki_min=0.005, end_velocity=10.0)
CONTROL = dict(step_cost=(4.0e-3, 5.0e-2, 0.0), r_term=(1.0e-2, 10.0), final_cost=(1.0, 0.0, 0.1))
CONTROL_HORIZON, MAP_HORIZON = 16, 30
V_MAX_RUNTIME = 28.0
ADMM_MAX_ITER = 20000
MAP_AY_MAX, MAP_A_MIN = 7.0, -0.15
SWEEP_STEPS, FULL_LAP_STEPS = 20, 30
HALF_WIDTH, DT = 5.0, 0.1
SCAN_SYSTEMS = ("n1024", "nworld", "batched")


def make_mpc(horizon: int) -> SpatialMPC:
    return SpatialMPC(
        MPCConfig(horizon=horizon, constraints=SpeedProfileConstraints(**CONS), **CONTROL),
        SpatialBicycleModel(VehicleParams(), CONS["v_min"], CONS["v_max"]),
        device="cpu",
    )


def _slab(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's contiguous slab of the last axis."""
    per = x.shape[-1] // mesh.size
    i = mesh.axis_index()
    return torch.as_tensor(x[..., i * per : (i + 1) * per].copy())


def case_tridiag(mesh, inp, out):
    for tag in SCAN_SYSTEMS:
        parts = [_slab(inp[f"tridiag/{tag}/{k}"], mesh) for k in ("sub", "diag", "sup", "rhs")]
        out[f"tridiag/{tag}/x"] = tridiag_solve_sharded(*parts, mesh, "x").numpy()


def case_scan(mesh, inp, out):
    v = solve_speed_profile_sharded(
        _slab(inp["scan/ds"], mesh), _slab(inp["scan/kappas"], mesh),
        SpeedProfileConstraints(**CONS), mesh, "x",
        v_max_runtime=V_MAX_RUNTIME, use_end_velocity=True,
    )
    out["scan/v"] = v.numpy()


def case_admm(mesh, inp, out):
    kinds = ("from_prev", "from_next", "all_gather", "pmax")
    before = [mesh.calls[k] for k in kinds]
    sent = [mesh.elements[k] for k in kinds]
    sol = solve_speed_profile_admm_sharded(
        _slab(inp["admm/ds"], mesh), _slab(inp["admm/kappas"], mesh),
        SpeedProfileConstraints(**CONS), mesh, "x",
        v_max_runtime=V_MAX_RUNTIME, cfg=ADMMConfig(max_iter=ADMM_MAX_ITER),
    )
    out["admm/v"] = sol.velocities.numpy()
    for k in ("status", "iterations", "r_prim", "r_dual"):
        out[f"admm/{k}"] = getattr(sol, k).numpy()
    out["admm/calls"] = np.asarray([mesh.calls[k] - n for k, n in zip(kinds, before)])
    out["admm/elements"] = np.asarray([mesh.elements[k] - n for k, n in zip(kinds, sent)])


def case_map(mesh, inp, out):
    mpc = make_mpc(MAP_HORIZON)
    path = construct_waypoints(torch.as_tensor(inp["map/coords"]))
    sharded = mpc.compute_map_speed_profile(path, MAP_AY_MAX, MAP_A_MIN, mesh=mesh)
    out["map/v"] = sharded.velocities.numpy()


def case_realmap(mesh, inp, out):
    mpc = racing_mpc("cpu", rti=None)
    limits = load_config(ROOT / "configs" / "monza.yaml").map_speed_profile
    for name in PROFILE_MAPS:
        path = profile_path(mpc, name)
        out[f"realmap/{name}"] = mpc.compute_map_speed_profile(
            path, limits.ay_max, limits.a_min, mesh=mesh
        ).velocities.numpy()


def case_control(mesh, inp, out):
    mpc = make_mpc(CONTROL_HORIZON)
    refs = scenario_sharding(mesh, "x").local(inp["control/refs"])
    step = sharded_get_control(mpc, mesh, "x")
    states, fleet = step(replicate_state(mpc, refs.shape[0]), refs)
    out["control/projected_control"] = states.projected_control.numpy()
    for k, v in fleet.items():
        out[f"control/{k}"] = v.numpy()


def _sweep(inp):
    mpc = make_mpc(CONTROL_HORIZON)
    tm = track_map_from_numpy({k: inp[f"sweep/{k}"] for k in ("centre", "left", "right")}, device="cpu")
    grid = sweep_grid_from_numpy(
        {k: inp[f"sweep/{k}"] for k in ("start_index", "lateral_offset", "v_max")}, device="cpu"
    )
    return LapSweep(mpc, tm, half_width=HALF_WIDTH, dt=DT), grid


def case_sweep(mesh, inp, out):
    pod = make_pod_mesh(hosts=2, device="cpu")
    sweep, grid = _sweep(inp)
    metrics, fleet = sharded_lap_sweep(sweep, pod, SWEEP_STEPS)(put_global(grid, grid_sharding(pod)))
    out["sweep/v"] = metrics["v"].numpy()
    for k, v in fleet.items():
        out[f"sweep/{k}"] = v.numpy()
    fleet = sharded_full_lap(sweep, pod, FULL_LAP_STEPS, DT)(put_global(grid, grid_sharding(pod)))
    for k, v in fleet.items():
        out[f"full_lap/{k}"] = v.numpy()


def case_pod(mesh, inp, out):
    pod = make_pod_mesh(hosts=2, device="cpu")
    out["pod/coords"] = np.asarray([pod.coords["host"], pod.coords["chip"]])
    value = torch.tensor(float(10 * pod.rank + 1))
    for axes in ("host", "chip", None):
        tag = axes or "both"
        out[f"pod/psum_{tag}"] = pod.psum(value, axes).numpy()
        out[f"pod/pmax_{tag}"] = pod.pmax(value, axes).numpy()
        out[f"pod/index_{tag}"] = np.asarray(pod.axis_index(axes))
    out["pod/gather_chip"] = pod.all_gather(value, "chip").numpy()
    out["pod/next_chip"] = pod.from_next(value, fill=-1.0, axis="chip").numpy()
    out["pod/prev_host"] = pod.from_prev(value, fill=-1.0, axis="host").numpy()


def case_submesh(mesh, inp, out):
    """make_mesh below the world size (a mesh of rank 0 alone and, at four
    ranks, one of ranks 0-1), made on every rank in the same order, and
    above it. Members run the sharded control step on their rows; the
    others hold no rows and their collectives raise."""
    world = mesh.size
    mpc = make_mpc(CONTROL_HORIZON)
    everything = torch.as_tensor(inp["submesh/refs"])
    states, _ = mpc.batched_get_control(replicate_state(mpc, len(everything)), everything)
    out["submesh/batched"] = states.projected_control.numpy()
    for n in (1, 2) if world > 2 else (1,):
        sub = make_mesh(n, device="cpu", axis_name="x")
        tag = f"submesh/{n}"
        refs = scenario_sharding(sub, "x").local(inp["submesh/refs"])
        out[f"{tag}/is_member"] = np.asarray(sub.is_member)
        out[f"{tag}/rows"] = np.asarray(refs.shape[0])
        if sub.is_member:
            states, fleet = sharded_get_control(mpc, sub, "x")(replicate_state(mpc, len(refs)), refs)
            out[f"{tag}/projected_control"] = states.projected_control.numpy()
            out[f"{tag}/n_solved"] = fleet["n_solved"].numpy()
            out[f"{tag}/index"] = np.asarray(sub.axis_index("x"))
            out[f"{tag}/psum"] = sub.psum(torch.tensor(10.0 * sub.global_rank + 1), "x").numpy()
        else:
            try:
                sub.psum(torch.tensor(1.0), "x")
            except RuntimeError as err:
                out[f"{tag}/error"] = np.asarray(str(err))
    try:
        make_mesh(world + 1, device="cpu")
    except ValueError as err:
        out["submesh/above_error"] = np.asarray(str(err))


CASES = {
    "tridiag": case_tridiag,
    "scan": case_scan,
    "admm": case_admm,
    "map": case_map,
    "realmap": case_realmap,
    "control": case_control,
    "sweep": case_sweep,
    "pod": case_pod,
    "submesh": case_submesh,
}


def main(directory: str, world: int, rank: int) -> None:
    torch.set_num_threads(1)
    directory = pathlib.Path(directory)
    initialize_distributed(f"file://{directory}/store", world, rank, device="cpu", backend="gloo")
    inp = dict(np.load(directory / "inputs.npz"))
    mesh = make_mesh(device="cpu", axis_name="x")
    out = {}
    for name, case in CASES.items():
        if any(k.startswith(f"{name}/") for k in inp):
            case(mesh, inp, out)
    np.savez(directory / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
