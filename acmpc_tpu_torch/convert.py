"""Carry state across between the JAX package and the port.

Values cross as numpy arrays, so neither side imports the other: a
caller turns a JAX ``MPCState`` (or a lap sweep's ``CarState``,
``SweepGrid`` or ``TrackMap``, the FPN's Flax variables, or a particle
filter's ``PFState``) into a
mapping of numpy arrays (field name -> array, or the variables tree with
numpy leaves) and hands it here, and back.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from acmpc_tpu_torch.bench.lap_sweep import CarState, SweepGrid
from acmpc_tpu_torch.config.schema import PerceptionConfig
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.localise.particle_filter import PFState
from acmpc_tpu_torch.localise.track_map import TrackMap
from acmpc_tpu_torch.models.fpn_resnet18 import state_dict_from_flax
from acmpc_tpu_torch.mpc.spatial_mpc import MPCState
from acmpc_tpu_torch.perception.perceiver import Perceiver

_MPC_STATE_DTYPES = {
    "infeasibility_counter": torch.int32,
    "solved": torch.bool,
}


def _from_numpy(cls, arrays: Mapping[str, np.ndarray], device, dtypes=None):
    """``cls`` (a dataclass of tensors) from numpy arrays keyed by field
    name: fp32 unless ``dtypes`` names another type."""
    device = resolve_device(device)
    dtypes = dtypes or {}
    return cls(
        **{
            f.name: torch.tensor(
                np.asarray(arrays[f.name]),
                dtype=dtypes.get(f.name, torch.float32),
                device=device,
            )
            for f in dataclasses.fields(cls)
        }
    )


def _to_numpy(value) -> dict[str, np.ndarray]:
    return {
        f.name: getattr(value, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(value)
    }


def mpc_state_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> MPCState:
    """An ``MPCState`` from numpy arrays keyed by field name (fp32 floats,
    int32 counter, bool flag)."""
    return _from_numpy(MPCState, arrays, device, _MPC_STATE_DTYPES)


def mpc_state_to_numpy(state: MPCState) -> dict[str, np.ndarray]:
    """Field name -> numpy array (on the host) of an ``MPCState``."""
    return _to_numpy(state)


def car_state_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> CarState:
    """A lap sweep's ``CarState`` (x, y, yaw, v; fp32)."""
    return _from_numpy(CarState, arrays, device)


def car_state_to_numpy(car: CarState) -> dict[str, np.ndarray]:
    return _to_numpy(car)


def sweep_grid_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> SweepGrid:
    """A ``SweepGrid`` (int64 start indices, fp32 offsets and caps)."""
    return _from_numpy(SweepGrid, arrays, device, {"start_index": torch.int64})


def track_map_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> TrackMap:
    """A ``TrackMap`` from its centre, left and right (M, 2) polylines."""
    return _from_numpy(TrackMap, arrays, device)


_PF_STATE_DTYPES = {
    "valid": torch.bool,
    "converged": torch.bool,
    "previously_converged": torch.bool,
    "seeded": torch.bool,
    "seed_obs_count": torch.int32,
}


def pf_state_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> PFState:
    """A particle filter's ``PFState`` from numpy arrays keyed by field
    name (fp32, bool flags, int32 scan count). A JAX state's PRNG key, if
    present, is left behind: the port's draws are the caller's."""
    return _from_numpy(PFState, arrays, device, _PF_STATE_DTYPES)


def pf_state_to_numpy(state: PFState) -> dict[str, np.ndarray]:
    """Field name -> numpy array (on the host) of a ``PFState``."""
    return _to_numpy(state)


def qp_from_numpy(P, q, A, l, u, device: torch.device | str | None = None):
    """A (P, q, A, l, u) QP as fp32 tensors on ``device``."""
    device = resolve_device(device)
    return tuple(
        torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
        for v in (P, q, A, l, u)
    )


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def fpn_state_dict_from_numpy(variables: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``FPNResNet18`` state dict of the Flax variables tree
    (``{"params", "batch_stats"}``, any array leaves turned into numpy),
    in the leaves' dtypes."""
    return state_dict_from_flax(_numpy_tree(variables))


def perceiver_from_numpy(
    cfg: PerceptionConfig, variables: Mapping, device: torch.device | str | None = None
) -> Perceiver:
    """A ``Perceiver`` with the FPN weights of a Flax variables tree (the
    JAX package's exact weights, carried across as numpy)."""
    return Perceiver(cfg, _numpy_tree(variables), device)
