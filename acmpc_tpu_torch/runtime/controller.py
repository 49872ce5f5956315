"""Controller facade and free-running control thread.

Counterpart of ``acmpc_tpu/runtime/controller.py``. The MPC re-solve loop
is a thread (PyTorch releases the GIL while it launches work on the card)
consuming a centreline mailbox and publishing command sets to a mailbox:
free-running, latest wins, no busy-wait. The command set crosses threads
as numpy; the one host read of a solve, ``bool(new_state.solved)``, is
on the control thread.

Both MPCs (mapping horizon, racing horizon) are built up front on the
controller's device (CUDA unless the caller names another); the active
one is switched by ``is_mapping``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import AgentConfig
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.geometry.path import ReferencePath
from acmpc_tpu_torch.mpc.spatial_mpc import SpatialMPC, build_mpc
from acmpc_tpu_torch.runtime.commands import TemporalCommandSelector
from acmpc_tpu_torch.runtime.mailbox import Mailbox


@dataclasses.dataclass
class CommandSet:
    timestamp: float
    controls: np.ndarray  # (n, 2): [velocity, delta] rows
    cum_time: np.ndarray  # (n,)
    prediction: np.ndarray  # (n, 2)


class Controller:
    def __init__(
        self,
        cfg: AgentConfig,
        clock=None,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        """``clock``: time source used to stamp command sets and to
        compute the elapsed time for temporal command selection. Defaults
        to the wall clock (``time.monotonic``, right against a real-time
        game); a discrete-time simulator passes its own sim clock so the
        selection stays correct however fast or slow the host runs the
        loop. ``dtype``: the MPCs' type, float32 (the port is fp32
        throughout; any other raises)."""
        self._cfg = cfg
        self._clock = clock or time.monotonic
        self.device = resolve_device(device)
        self.mapping_mpc = build_mpc(
            _control_dict(cfg.mapping_control), cfg.vehicle, self.device, dtype
        )
        self.racing_mpc = build_mpc(
            _control_dict(cfg.racing_control), cfg.vehicle, self.device, dtype
        )
        self._centreline_box = Mailbox()
        self._command_box = Mailbox()
        self._selector = TemporalCommandSelector()
        self._thread: Optional[_ControlThread] = None

        self.is_mapping = cfg.create_map
        self.is_localised = False
        # solves run by the control thread and their wall seconds
        self.n_solves = 0
        self.solve_s = 0.0
        self.reference_speed = (
            cfg.racing_control.unlocalised_max_speed
            or cfg.racing_control.constraints.v_max
        )

    # -- facade API ------------------------------------------------------
    @property
    def mpc(self) -> SpatialMPC:
        return self.mapping_mpc if self.is_mapping else self.racing_mpc

    @property
    def delta_max(self) -> float:
        return self.racing_mpc.delta_max

    @property
    def a_max(self) -> float:
        return self.racing_mpc.config.constraints.a_max

    @property
    def desired_state(self):
        """(velocity, delta) active now: elapsed-time command selection."""
        cmds, version, _ = self._command_box.read()
        if cmds is None:
            return 0.0, 0.0
        elapsed = self._clock() - cmds.timestamp
        v, delta = self._selector(cmds.cum_time, cmds.controls, elapsed)
        return float(v), float(delta)

    @property
    def predicted_locations(self) -> Optional[np.ndarray]:
        cmds, _, _ = self._command_box.read()
        return None if cmds is None else cmds.prediction

    def submit_centreline(self, centreline: np.ndarray):
        """Fresh centreline from perception -> wake the control thread.
        The submission clock reading rides along: the solved plan's
        cum_time is relative to THIS observation, so command sets are
        stamped with it (stamping at publish would shift every command
        late by the solve latency)."""
        self._centreline_box.post((np.asarray(centreline), self._clock()))

    def compute_track_speed_profile(self, track_xyw: np.ndarray) -> ReferencePath:
        """Full-map speed profile with the map-specific constraint
        overrides."""
        mpc = self.racing_mpc
        path = mpc.construct_waypoints(np.asarray(track_xyw, np.float32))
        return mpc.compute_map_speed_profile(
            path,
            ay_max=self._cfg.map_speed_profile.ay_max,
            a_min=self._cfg.map_speed_profile.a_min,
        )

    def start(self):
        if self._thread is None:
            self._thread = _ControlThread(self)
            self._thread.start()

    def wait_for_first_command(self, timeout: float = 120.0) -> bool:
        """Block until the control thread has published its first command
        set (covers the first solve's kernel builds)."""
        _, version, _ = self._command_box.read_fresh(0, timeout=timeout)
        return version > 0

    @property
    def command_version(self) -> int:
        """Monotonic counter of published command sets."""
        return self._command_box.version

    def wait_for_command_newer_than(
        self, version: int, timeout: float = 30.0
    ) -> int:
        """Block until a command set newer than ``version`` exists; returns
        the version seen. Lockstep pacing for deterministic closed-loop
        runs: a discrete-time sim can outrun the free-running solve
        thread on a loaded host, leaving the car tracking a plan solved
        for a pose far behind."""
        _, v, _ = self._command_box.read_fresh(version, timeout=timeout)
        return v

    def shutdown(self):
        if self._thread is not None:
            self._thread.stop()
            self._thread.join(timeout=5)
            self._thread = None

    # -- used by the control thread --------------------------------------
    def _publish(self, commands: CommandSet):
        self._command_box.post(commands)


def _control_dict(mpc_cfg) -> dict:
    c = mpc_cfg.constraints
    return {
        "horizon": mpc_cfg.horizon,
        "step_cost": list(mpc_cfg.step_cost),
        "r_term": list(mpc_cfg.r_term),
        "final_cost": list(mpc_cfg.final_cost),
        "unlocalised_max_speed": mpc_cfg.unlocalised_max_speed,
        "speed_profile_constraints": {
            "v_min": c.v_min,
            "v_max": c.v_max,
            "a_min": c.a_min,
            "a_max": c.a_max,
            "ay_max": c.ay_max,
            "ki_min": c.ki_min,
            "end_velocity": c.end_velocity,
        },
    }


class _ControlThread(threading.Thread):
    """Free-running MPC re-solve loop: wake on a fresh centreline, solve,
    publish."""

    def __init__(self, controller: Controller):
        super().__init__(daemon=True, name="acmpc-control")
        self._c = controller
        self._stop_event = threading.Event()
        self._states = {
            id(controller.mapping_mpc): controller.mapping_mpc.initial_state(),
            id(controller.racing_mpc): controller.racing_mpc.initial_state(),
        }
        self._version = 0

    def stop(self):
        self._stop_event.set()
        self._c._centreline_box.post(None)  # wake the wait

    def run(self):
        while not self._stop_event.is_set():
            item, version, _ = self._c._centreline_box.read_fresh(
                self._version, timeout=0.5
            )
            if version == self._version or item is None:
                continue
            self._version = version
            centreline, stamp = item
            try:
                self._solve(np.asarray(centreline), stamp)
            except Exception:  # keep the loop alive
                import traceback

                traceback.print_exc()

    @torch.no_grad()
    def _solve(self, centreline: np.ndarray, stamp: float):
        t0 = time.perf_counter()
        mpc = self._c.mpc
        horizon = mpc.horizon
        # downsample to the horizon with tapered widths
        ds = max(1, int(len(centreline) / horizon))
        pts = centreline[::ds][:horizon]
        if len(pts) < horizon:  # pad by repeating the last point
            pad = np.repeat(pts[-1:], horizon - len(pts), axis=0)
            pts = np.concatenate([pts, pad])
        widths = np.linspace(10.0, 6.0, horizon)
        ref = np.stack([pts[:, 0], pts[:, 1], widths]).T

        state = self._states[id(mpc)]
        new_state, diags = mpc.jitted_get_control(
            state,
            np.asarray(ref, np.float32),
            float(self._c.reference_speed),
            bool(self._c.is_localised),
        )
        self._states[id(mpc)] = new_state
        if bool(new_state.solved):
            self._c._publish(
                CommandSet(
                    timestamp=stamp,
                    controls=new_state.projected_control.cpu().numpy().T,
                    cum_time=new_state.cum_time.cpu().numpy(),
                    prediction=new_state.prediction.cpu().numpy(),
                )
            )
        self._c.n_solves += 1
        self._c.solve_s += time.perf_counter() - t0
