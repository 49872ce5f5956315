"""Carry state across between the JAX package and the port.

Values cross as numpy arrays, so neither side imports the other: a
caller turns a JAX ``MPCState`` into a mapping of numpy arrays (field
name -> array) and hands it here, and back.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.mpc.spatial_mpc import MPCState

_MPC_STATE_DTYPES = {
    "infeasibility_counter": torch.int32,
    "solved": torch.bool,
}


def mpc_state_from_numpy(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> MPCState:
    """An ``MPCState`` from numpy arrays keyed by field name (fp32 floats,
    int32 counter, bool flag)."""
    device = resolve_device(device)
    return MPCState(
        **{
            f.name: torch.tensor(
                np.asarray(arrays[f.name]),
                dtype=_MPC_STATE_DTYPES.get(f.name, torch.float32),
                device=device,
            )
            for f in dataclasses.fields(MPCState)
        }
    )


def mpc_state_to_numpy(state: MPCState) -> dict[str, np.ndarray]:
    """Field name -> numpy array (on the host) of an ``MPCState``."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(MPCState)
    }


def qp_from_numpy(P, q, A, l, u, device: torch.device | str | None = None):
    """A (P, q, A, l, u) QP as fp32 tensors on ``device``."""
    device = resolve_device(device)
    return tuple(
        torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
        for v in (P, q, A, l, u)
    )
