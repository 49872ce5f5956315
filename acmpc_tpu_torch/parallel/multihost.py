"""Multi-process execution: the process group, the ("host", "chip") mesh
and the sharded closed-loop sweeps.

Counterpart of ``acmpc_tpu/parallel/multihost.py``. JAX runs one process
per host and shards over all of its chips; the port runs one process per
rank, each driving one device:

* ``initialize_distributed``: the process group for a launch of several
  processes (a no-op for one), with an explicit backend policy;
* ``make_pod_mesh``: a ("host", "chip") mesh, rank = host * per_host +
  chip, with a process group for each axis and for both;
* ``put_global``: every rank builds the same global value (from one
  seed) and keeps its own rows: no data moves at ingest;
* ``sharded_lap_sweep`` and ``sharded_full_lap``: the closed-loop sweeps
  with the scenarios split over both axes and a fleet summary reduced
  over them, the only traffic between ranks;
* ``spawn_ranks``: start the ranks of a launch on one machine as
  processes and wait for them, raising (not hanging) when one fails.

Backend policy, never a silent switch: ``nccl`` is the default on CUDA,
where each rank needs a card of its own (asking for it with more ranks
on a host than cards raises, naming ``gloo``); ``gloo`` is the CPU's
backend, and on CUDA it serves ranks that share a card only when the
caller names it. Every process group has a timeout, so a missing peer
fails rather than hangs.
"""

from __future__ import annotations

import datetime
import pathlib
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, Mesh, ScenarioSharding, rank_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
_HOST_KEY = "acmpc_host/"


def resolve_backend(device: torch.device, backend: str | None) -> str:
    """The backend for ranks on ``device``: ``nccl`` by default on CUDA,
    ``gloo`` on the CPU; ``nccl`` on the CPU raises."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} cannot move host tensors; use 'gloo' on the CPU")
        return "gloo"
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or 'gloo'")
    return backend or "nccl"


def check_cards(backend: str, local_ranks: int, cards: int) -> None:
    """nccl needs a card for each rank on a host (two ranks on one card
    fail inside NCCL as a duplicate GPU); raise, naming gloo, before
    the group is made."""
    if backend == "nccl" and local_ranks > cards:
        raise ValueError(
            f"nccl needs a card for each rank: {local_ranks} ranks share "
            f"{cards} card(s) on {socket.gethostname()}; pass backend='gloo' "
            "to run ranks that share a card"
        )


def _store(coordinator_address: str | None, world_size: int, rank: int, timeout):
    """The rendezvous store: ``file://<path>`` (a FileStore, for launches
    on one machine) or ``host:port`` (a TCPStore served by rank 0)."""
    if coordinator_address is None:
        if world_size > 1:
            raise ValueError(f"{world_size} processes need a coordinator address")
        return dist.HashStore()
    if coordinator_address.startswith("file://"):
        store = dist.FileStore(coordinator_address.removeprefix("file://"), world_size)
        store.set_timeout(timeout)
        return store
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator_address!r} is neither host:port nor file://path")
    return dist.TCPStore(host, int(port), world_size, is_master=rank == 0, timeout=timeout)


def _host_slot(store, rank: int, world_size: int, timeout) -> tuple[int, int]:
    """(this rank's index among the ranks on its host, their number),
    from every rank's host name published through the store."""
    store.set(f"{_HOST_KEY}{rank}", socket.gethostname())
    keys = [f"{_HOST_KEY}{r}" for r in range(world_size)]
    store.wait(keys, timeout)
    hosts = [store.get(k).decode() for k in keys]
    mine = [r for r in range(world_size) if hosts[r] == hosts[rank]]
    return mine.index(rank), len(mine)


def start_process_group(
    coordinator_address: str | None,
    world_size: int,
    rank: int,
    device=None,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join (or, at a world of one, make) the default process group and
    return this rank's device: ``cuda:<its index among the ranks on its
    host>`` (modulo the cards, for gloo ranks that share one) or the
    CPU."""
    device = resolve_device(device)
    backend = resolve_backend(device, backend)
    store = _store(coordinator_address, world_size, rank, timeout)
    local_rank, local_ranks = _host_slot(store, rank, world_size, timeout)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        check_cards(backend, local_ranks, cards)
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size, timeout=timeout
    )
    return rank_device(device)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Start the process group of a launch of ``num_processes`` processes
    (call once per process before any collective) and return this
    rank's device. A no-op for one process: its mesh needs no group."""
    if num_processes is None or num_processes <= 1:
        device = resolve_device(device)
        resolve_backend(device, backend)
        return rank_device(device)
    return start_process_group(
        coordinator_address, num_processes, process_id or 0, device, backend, timeout
    )


def put_global(tree, sharding: ScenarioSharding):
    """This rank's rows of a global value every rank built alike (a
    tensor, an array, or a dataclass of them), on the mesh's device."""
    return sharding.local(tree)


def make_pod_mesh(hosts: int | None = None, axis_names=("host", "chip"), device=None) -> Mesh:
    """("host", "chip") mesh over every rank: ``hosts`` rows (one a rank
    by default, as JAX's one process a host) of world / hosts ranks."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    hosts = hosts or world
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    return Mesh(dict(zip(axis_names, (hosts, world // hosts))), device)


def grid_sharding(mesh: Mesh) -> ScenarioSharding:
    """Shard the leading scenario axis over every mesh axis jointly."""
    return ScenarioSharding(mesh, mesh.axis_names)


def sharded_lap_sweep(sweep, mesh: Mesh, n_steps: int):
    """Mesh-sharded closed-loop sweep: each rank runs
    ``LapSweep.run_fused`` on its rows of the grid.

    Returns ``run(grid) -> (metrics, fleet)``: ``grid`` and ``metrics``
    are this rank's rows; ``fleet`` holds the same scalars on every rank
    (solves succeeded and made, the worst off-track distance, the mean
    speed), the only traffic between ranks.
    """
    axes = mesh.axis_names

    def run(grid):
        _, metrics = sweep.run_fused(grid, n_steps)
        n_local = metrics["v"].shape[0] * n_steps
        counts = mesh.psum(
            torch.stack([metrics["solved"].sum(), torch.tensor(n_local, device=mesh.device)]), axes
        )
        fleet = {
            "n_solved": counts[0],
            "n_solves": counts[1],
            "worst_offtrack": mesh.pmax(metrics["offtrack"].max(), axes),
            "mean_speed": mesh.pmean(metrics["v"].mean(), axes),
        }
        return metrics, fleet

    return run


def sharded_full_lap(sweep, mesh: Mesh, max_steps: int, dt: float):
    """Mesh-sharded full-lap endurance sweep: every scenario drives
    exactly ``max_steps`` closed-loop steps, its lap progress tracked on
    the device (map-index deltas along the reference polyline times its
    mean spacing) with no host read a step, and the fleet summary reduced
    over the mesh at the end. Returns ``run(grid) -> fleet``, the same
    scalars on every rank; lap times are ``lap_steps * dt``."""
    axes = mesh.axis_names
    centre = sweep._centre
    m = centre.shape[0]
    lap_len = torch.sum(torch.linalg.norm(torch.roll(centre, -1, dims=0) - centre, dim=-1))
    spacing = lap_len / m

    def run(grid):
        cars, states, prev_i0 = sweep.start(grid)
        b = prev_i0.shape[0]
        device = prev_i0.device
        progress = torch.zeros(b, dtype=centre.dtype, device=device)
        lap_step = torch.full((b,), -1, dtype=torch.int64, device=device)
        n_solved = torch.zeros(b, dtype=torch.int64, device=device)
        fail_max_iter = torch.zeros_like(n_solved)
        fail_infeasible = torch.zeros_like(n_solved)
        worst_off = torch.zeros(b, dtype=centre.dtype, device=device)
        v_sum = torch.zeros(b, dtype=centre.dtype, device=device)
        for step in range(max_steps):
            cars, states, metrics, i0 = sweep.fused_step(cars, states, grid.v_max, prev_i0)
            delta = torch.remainder(i0 - prev_i0, m)
            # windows only move forward; a large residual is wrap noise
            delta = torch.where(delta > m // 2, 0, delta)
            progress = progress + delta * spacing
            lap_step = torch.where((lap_step < 0) & (progress >= lap_len), step + 1, lap_step)
            prev_i0 = i0
            solved = metrics["solved"]
            status = metrics["control_status"]
            n_solved += solved
            # QP status (qp/admm.py): 0 the iteration budget, 2 a primal
            # infeasibility certificate
            fail_max_iter += ~solved & (status == 0)
            fail_infeasible += ~solved & (status == 2)
            worst_off = torch.maximum(worst_off, metrics["offtrack"])
            v_sum = v_sum + metrics["v"]
        done = lap_step > 0
        counts = mesh.psum(torch.stack([
            torch.tensor(b, device=device),
            torch.tensor(b * max_steps, device=device),
            n_solved.sum(),
            done.sum(),
            torch.where(done, lap_step, 0).sum(),
            fail_max_iter.sum(),
            fail_infeasible.sum(),
        ]), axes)
        big = torch.iinfo(torch.int32).max
        return {
            "n_scenarios": counts[0],
            "n_solves": counts[1],
            "n_solved": counts[2],
            "completed_laps": counts[3],
            "lap_steps_sum": counts[4],
            "lap_steps_min": mesh.pmin(torch.where(done, lap_step, big).min(), axes),
            "worst_offtrack": mesh.pmax(worst_off.max(), axes),
            "mean_speed": mesh.pmean(v_sum.sum() / (b * max_steps), axes),
            "fail_max_iter": counts[5],
            "fail_infeasible": counts[6],
        }

    return run


def spawn_ranks(argv_of, world: int, timeout: float, env=None) -> list[str]:
    """Start ``world`` processes from the repository's root, rank r
    running ``argv_of(r)``, and wait for all of them; returns each one's
    standard output.

    Raises ``RuntimeError`` with the output of the first rank that exits
    with another code than 0, or of one still running at ``timeout``
    seconds; the other ranks are killed then, so a rank waiting on a
    peer that died does not hang the launch. Only the processes started
    here are killed.
    """
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = []
    failed = None
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                argv_of(rank), stdout=logs[rank][0], stderr=logs[rank][1],
                text=True, env=env, cwd=ROOT,
            ))
        deadline = time.monotonic() + timeout
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exited with code {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                running = codes.index(None)
                failed = (running, f"did not finish within {timeout} s")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        outs.append((out.read(), err.read()))
        out.close()
        err.close()
    if failed is not None:
        rank, why = failed
        raise RuntimeError(
            f"rank {rank} of {world} {why}:\n{outs[rank][0]}\n{outs[rank][1]}"
        )
    return [out for out, _ in outs]
