"""Benchmark metric tracking.

Counterpart of ``acmpc_tpu/localise/benchmarking/tracker.py``, with the
same ``summary()`` keys: convergence and reset counts, the per-step x, y
and yaw error against ground truth while localised, the split of the
convergence transient from steady-state tracking, and the host time of
each ``step`` and ``observe_tracklimits`` call. Those two times are
dispatch times: the tracker reads ``is_localised`` after its caller's
timer stops, and that read is what waits for the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class LocalisationTracker:
    def __init__(self, localiser, gt_poses: List):
        self._localiser = localiser
        self._gt_poses = gt_poses
        self._n_steps = 0
        self._n_total_steps = 0
        self._n_total_observations = 0
        self._n_resets = 0
        self._previous_localised = False
        self._n_steps_localised_for: List[int] = []
        self._n_steps_to_convergence: List[int] = []
        self.observation_execution_times: List[float] = []
        self.step_execution_times: List[float] = []
        self._errors = {"x": [], "y": [], "yaw": []}
        # the localised flag of every step and the step of every error
        # sample, to split the transient from the steady state
        self._step_localised: List[bool] = []
        self._error_steps: List[int] = []

    # -- per-event updates ----------------------------------------------
    def update_step(self, execution_time: float):
        self.step_execution_times.append(execution_time)
        self._step_localised.append(bool(self._localiser.is_localised))
        self._calculate_error()
        self._n_steps += 1
        self._n_total_steps += 1

    def update_observation(self, execution_time: float):
        self.observation_execution_times.append(execution_time)
        localised = self._localiser.is_localised
        if self._previous_localised and not localised:  # reset
            self._n_steps_localised_for.append(self._n_steps)
            self._n_resets += 1
            self._n_steps = 0
        if localised and not self._previous_localised:  # converged
            self._n_steps_to_convergence.append(self._n_steps)
            self._n_steps = 0
        self._previous_localised = localised
        self._n_total_observations += 1

    def _calculate_error(self):
        if not self._localiser.is_localised:
            return
        if self._n_total_steps >= len(self._gt_poses):
            return
        est = self._localiser.estimated_position
        gt = self._current_ground_truth()
        self._error_steps.append(self._n_total_steps)
        self._errors["x"].append(gt["x"] - est[0])
        self._errors["y"].append(gt["y"] - est[1])
        self._errors["yaw"].append((gt["yaw"] - est[2] + np.pi) % (2 * np.pi) - np.pi)

    def _current_ground_truth(self) -> Dict:
        pose = self._gt_poses[self._n_total_steps]
        if isinstance(pose, dict):
            return pose
        # the original stack's layout: [x_game, y, z, yaw] with x negated
        p = np.asarray(pose).reshape(-1)
        return {"x": -1.0 * p[0], "y": p[2], "yaw": p[3]}

    # -- summaries --------------------------------------------------------
    def average_position_error(self) -> float:
        if not self._errors["x"]:
            return float("nan")
        return float(np.mean(np.abs(self._errors["x"]) + np.abs(self._errors["y"])))

    def average_rotation_error(self) -> float:
        if not self._errors["yaw"]:
            return float("nan")
        return float(np.mean(np.abs(self._errors["yaw"])))

    def percentage_of_steps_localised_for(self) -> float:
        localised = sum(self._n_steps_localised_for) + (
            self._n_steps if self._previous_localised else 0
        )
        if self._n_total_steps == 0:
            return 0.0
        return 100.0 * localised / self._n_total_steps

    def steps_to_first_convergence(self):
        """Steps of the whole-track-prior transient; None if the filter
        never converged."""
        for i, loc in enumerate(self._step_localised):
            if loc:
                return i
        return None

    def steady_state_percent_localised(self) -> float:
        """% of steps localised after the first convergence."""
        first = self.steps_to_first_convergence()
        if first is None:
            return 0.0
        steady = self._step_localised[first:]
        return 100.0 * float(np.mean(steady)) if steady else 0.0

    def steady_state_position_error(self) -> float:
        """Mean |x| + |y| error over the localised steps after the first
        convergence."""
        first = self.steps_to_first_convergence()
        if first is None or not self._errors["x"]:
            return float("nan")
        keep = [i for i, s in enumerate(self._error_steps) if s >= first]
        if not keep:
            return float("nan")
        ex = np.abs(np.asarray(self._errors["x"])[keep])
        ey = np.abs(np.asarray(self._errors["y"])[keep])
        return float(np.mean(ex + ey))

    def summary(self) -> Dict:
        return {
            "percent_localised": self.percentage_of_steps_localised_for(),
            "steps_to_first_convergence": self.steps_to_first_convergence(),
            "steady_state_percent_localised": self.steady_state_percent_localised(),
            "steady_state_position_error_m": self.steady_state_position_error(),
            "mean_position_error_m": self.average_position_error(),
            "mean_rotation_error_deg": float(np.degrees(self.average_rotation_error())),
            "n_resets": self._n_resets,
            "n_steps": self._n_total_steps,
            "n_observations": self._n_total_observations,
            "step_p50_ms": float(np.percentile(self.step_execution_times or [0], 50) * 1e3),
            "observation_p50_ms": float(
                np.percentile(self.observation_execution_times or [0], 50) * 1e3
            ),
        }
