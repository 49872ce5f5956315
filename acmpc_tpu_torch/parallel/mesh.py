"""Scenario parallelism over a mesh of ranks on ``torch.distributed``.

Counterpart of ``acmpc_tpu/parallel/mesh.py``. JAX shards one program
over named mesh axes with ``shard_map``; the port runs one process per
rank, and a :class:`Mesh` names the axes over the process group: one
group per set of axes, the rank's coordinates, its device, and the
collectives the JAX code calls (``axis_index``, ``psum``, ``pmax``,
``pmin``, ``pmean``, ``all_gather`` and the two ``ppermute`` shifts,
``from_prev`` and ``from_next``). The sharded functions take the mesh
(and an axis name) where their JAX counterparts take an ``axis_name``.

The scaling axis is the scenario batch: each rank solves its rows with
no communication in the solve itself, and the fleet diagnostics (solved
counts, worst residuals) are reduced across ranks, a few scalars a step.

A process that never initialised ``torch.distributed`` is a mesh of one
rank: its collectives return their input. The backend is the process
group's (``parallel/multihost.py`` chooses it). Over gloo a collective
on a CUDA tensor is staged through the host (gloo moves host memory);
the tensors it moves here are a few scalars, or one halo element a side.

``make_mesh(n)`` with n below the world size is a sub-mesh over ranks
0..n-1, as JAX's takes the first n devices. Every rank makes it (a
process group is made by every rank of the world); the ranks outside
it get a mesh that does not hold them (``is_member`` False): they hold
no rows, and their collectives raise.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import math

import torch
import torch.distributed as dist

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.mpc.spatial_mpc import MPCState, SpatialMPC

# how long a rank waits on its peers: the rendezvous and every collective
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def rank_device(device=None) -> torch.device:
    """``device`` with its index written out: the current card for
    ``cuda``, as ``torch.cuda.set_device`` left it."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A row-major grid of ranks with named axes, over every rank of the
    default process group (or over one process with no group), or over
    the global ranks ``ranks`` in that order: a sub-mesh, which every
    rank of the world must make, members and outsiders alike. Every
    group it makes waits DEFAULT_TIMEOUT on a missing peer."""

    def __init__(self, shape: dict[str, int], device=None, ranks=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device = rank_device(device)
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            self._ranks = list(range(world) if ranks is None else ranks)
            distinct = set(self._ranks)
            fits = distinct <= set(range(world))
            if not (len(self._ranks) == len(distinct) == self.size and fits):
                raise ValueError(
                    f"a mesh of shape {self.shape} needs {self.size} of the process "
                    f"group's {world} ranks; got {self._ranks}"
                )
            self.global_rank = dist.get_rank()
            self.backend = dist.get_backend()
        elif self.size == 1 and (ranks is None or list(ranks) == [0]):
            self._ranks, self.global_rank, self.backend = [0], 0, None
        else:
            raise RuntimeError(
                f"a mesh of {self.size} ranks needs torch.distributed; call "
                "parallel.multihost.initialize_distributed first"
            )
        self.is_member = self.global_rank in self._ranks
        # this rank's position in the mesh; None outside it
        self.rank = self._ranks.index(self.global_rank) if self.is_member else None
        strides, acc = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = acc
            acc *= self.shape[name]
        self._strides = strides
        self.coords = (
            {n: (self.rank // strides[n]) % self.shape[n] for n in self.axis_names}
            if self.is_member
            else None
        )
        # collectives this rank took part in, by kind, and the elements it sent
        self.calls: collections.Counter = collections.Counter()
        self.elements: collections.Counter = collections.Counter()
        self._groups = self._make_groups(ranks is not None) if self.backend is not None else {}

    def __repr__(self) -> str:
        return (
            f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
            f"device={self.device}, backend={self.backend})"
        )

    # -- axes --------------------------------------------------------------
    def _axes(self, axis) -> tuple[str, ...]:
        if axis is None:
            return self.axis_names
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"no mesh axis {unknown}; the axes are {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)  # mesh order

    def axis_size(self, axis=None) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def _member(self) -> None:
        """Raise on a rank this mesh does not hold."""
        if not self.is_member:
            raise RuntimeError(
                f"rank {self.global_rank} is not in this mesh of {self.size} ranks "
                f"{self._ranks}: it holds no rows and takes part in no collective"
            )

    def axis_index(self, axis=None) -> int:
        """This rank's row-major position along ``axis`` (a name, a tuple
        of names, or None for all axes)."""
        self._member()
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _rank_at(self, axes: tuple[str, ...], index: int) -> int:
        """The global rank at position ``index`` along ``axes``, with this
        rank's coordinates on the other axes."""
        coords = dict(self.coords)
        for a in reversed(axes):
            coords[a] = index % self.shape[a]
            index //= self.shape[a]
        return self._ranks[sum(coords[a] * self._strides[a] for a in self.axis_names)]

    def _make_groups(self, sub_mesh: bool) -> dict:
        """One process group per set of axes that holds this rank. Every
        rank of the world creates every group, in the same order, as
        ``dist.new_group`` requires; the set of all axes is the default
        group, or for a sub-mesh a group of its own."""
        groups = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if k == len(self.axis_names) and not sub_mesh:
                    groups[axes] = None  # the default group: every rank
                    continue
                others = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    ranks = []
                    for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
                        c = dict(zip(others, fixed)) | dict(zip(axes, pos))
                        at = sum(c[a] * self._strides[a] for a in self.axis_names)
                        ranks.append(self._ranks[at])
                    group = dist.new_group(sorted(ranks), timeout=DEFAULT_TIMEOUT)
                    if self.is_member and all(self.coords[a] == f for a, f in zip(others, fixed)):
                        groups[axes] = group
        return groups

    # -- collectives ---------------------------------------------------------
    def _stage(self, x) -> torch.Tensor:
        """``x`` as a contiguous tensor the backend can move: on the host
        for gloo (it moves host memory), on the mesh's device otherwise."""
        x = torch.as_tensor(x, device=self.device)
        if x.dtype == torch.bool:
            x = x.to(torch.int64)
        if self.backend == "gloo":
            x = x.cpu()
        return x.contiguous().clone()

    def _reduce(self, x, op, axis, kind: str) -> torch.Tensor:
        self._member()
        axes = self._axes(axis)
        if self.backend is None:
            return torch.as_tensor(x, device=self.device)
        buf = self._stage(x)
        self.calls[kind] += 1
        self.elements[kind] += buf.numel()
        dist.all_reduce(buf, op=op, group=self._groups[axes])
        return buf.to(self.device)

    def psum(self, x, axis=None) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM, axis, "psum")

    def pmax(self, x, axis=None) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX, axis, "pmax")

    def pmin(self, x, axis=None) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN, axis, "pmin")

    def pmean(self, x, axis=None) -> torch.Tensor:
        return self.psum(x, axis) / self.axis_size(axis)

    def all_gather(self, x, axis=None) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, stacked in a new leading dim
        in axis order, on every rank."""
        self._member()
        axes = self._axes(axis)
        if self.backend is None:
            return torch.as_tensor(x, device=self.device)[None]
        buf = self._stage(x)
        self.calls["all_gather"] += 1
        self.elements["all_gather"] += buf.numel()
        out = [torch.empty_like(buf) for _ in range(self.axis_size(axes))]
        dist.all_gather(out, buf, group=self._groups[axes])
        return torch.stack(out).to(self.device)

    def _shift(self, x: torch.Tensor, fill, axis, step: int, kind: str) -> torch.Tensor:
        """Send ``x`` to the neighbour ``step`` along the axis and return
        what the one ``-step`` away sent; ``fill`` where there is none
        (``ppermute`` with the pairs (i, i + step))."""
        self._member()
        axes = self._axes(axis)
        idx, size = self.axis_index(axes), self.axis_size(axes)
        out = torch.full_like(x, fill)
        if self.backend is None:
            return out
        buf = self._stage(x)
        recv = torch.empty_like(buf)
        group = self._groups[axes]
        self.calls[kind] += 1
        ops = []
        if 0 <= idx + step < size:
            ops.append(dist.P2POp(dist.isend, buf, self._rank_at(axes, idx + step), group))
            self.elements[kind] += buf.numel()
        if 0 <= idx - step < size:
            ops.append(dist.P2POp(dist.irecv, recv, self._rank_at(axes, idx - step), group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if 0 <= idx - step < size:
            out = recv.to(self.device)
        return out

    def from_prev(self, x: torch.Tensor, fill=0.0, axis=None) -> torch.Tensor:
        """The predecessor's ``x`` along the axis; ``fill`` on the first."""
        return self._shift(x, fill, axis, 1, "from_prev")

    def from_next(self, x: torch.Tensor, fill=0.0, axis=None) -> torch.Tensor:
        """The successor's ``x`` along the axis; ``fill`` on the last."""
        return self._shift(x, fill, axis, -1, "from_next")


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device=None) -> Mesh:
    """1-D scenario mesh over the first ``n_devices`` ranks (every rank
    by default): one rank per device. Below the world size it is a
    sub-mesh, which every rank must make; the ranks at ``n_devices`` and
    above get a mesh with ``is_member`` False. More ranks than the world
    has raise."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n}): the world has {world} rank(s)")
    return Mesh({axis_name: n}, device, ranks=None if n == world else range(n))


@dataclasses.dataclass(frozen=True)
class ScenarioSharding:
    """The leading (scenario) axis split over ``axes`` of ``mesh``: each
    rank keeps a contiguous block of rows, in axis order."""

    mesh: Mesh
    axes: tuple[str, ...]

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n``; none outside a sub-mesh."""
        parts = self.mesh.axis_size(self.axes)
        if n % parts:
            raise ValueError(f"{n} scenarios do not split over {parts} ranks")
        if not self.mesh.is_member:
            return slice(0, 0)
        per = n // parts
        i = self.mesh.axis_index(self.axes)
        return slice(i * per, (i + 1) * per)

    def local(self, value):
        """This rank's rows of a global tensor or array, or of every field
        of a dataclass of them, on the mesh's device."""
        if dataclasses.is_dataclass(value):
            return type(value)(
                *(self.local(getattr(value, f.name)) for f in dataclasses.fields(value))
            )
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        return value[self.rows(value.shape[0])].to(self.mesh.device)


def scenario_sharding(mesh: Mesh, axis_name: str = "dp") -> ScenarioSharding:
    """Sharding that splits the leading (scenario) axis over the mesh."""
    return ScenarioSharding(mesh, mesh._axes(axis_name))


def sharded_get_control(mpc: SpatialMPC, mesh: Mesh, axis_name: str = "dp"):
    """A scenario-sharded batched MPC step.

    Returns ``step(states, refs) -> (states', fleet)``: each rank passes
    its own rows and gets its own rows back, through
    ``batched_get_control`` (JAX's local step vmaps ``get_control``);
    ``fleet`` holds the same reduced
    scalars on every rank (``n_solved`` summed, ``worst_r_prim`` and
    ``worst_infeasibility_counter`` maxed over the axis).
    """

    def step(states: MPCState, refs):
        new_states, diags = mpc.batched_get_control(states, refs)
        fleet = {
            "n_solved": mesh.psum(new_states.solved.sum(), axis_name),
            "worst_r_prim": mesh.pmax(diags.r_prim.max(), axis_name),
            "worst_infeasibility_counter": mesh.pmax(
                new_states.infeasibility_counter.max(), axis_name
            ),
        }
        return new_states, fleet

    return step


def replicate_state(mpc: SpatialMPC, batch: int) -> MPCState:
    """Batch of initial MPC states."""
    return mpc.initial_state(batch)
