"""Temporal command selection.

Own copy of ``acmpc_tpu/runtime/commands.py``. The MPC publishes a
command trajectory (velocities, steering deltas) with cumulative
solve-relative times; the real-time loop samples the command active "now"
(elapsed time since the trajectory was published), with the
nearest-then-step-back index rule. Host numpy, run per frame; the lap
sweep's on-device ``LapSweep._select_command`` mirrors the selector.
"""

from __future__ import annotations

import numpy as np


class TemporalCommandSelector:
    """Nearest-cum-time command selection.

    Stateless over (cum_time (n,), commands (n, d)). Steps back one index
    when the closest command is still in the future, and index 0 then
    wraps to the last command, as numpy indexing does.
    """

    def __call__(
        self, cum_time: np.ndarray, commands: np.ndarray, elapsed_time: float
    ) -> np.ndarray:
        distances = cum_time - elapsed_time
        index = int(np.argmin(np.abs(distances)))
        if distances[index] > 0:
            index -= 1
        index = min(index, len(commands) - 1)
        return commands[index]


class TemporalCommandInterpolator:
    """Linear interpolation between the two bracketing commands."""

    def __call__(
        self, cum_time: np.ndarray, commands: np.ndarray, elapsed_time: float
    ) -> np.ndarray:
        distances = cum_time - elapsed_time
        index_a = int(np.argmin(np.abs(distances)))
        distance = distances[index_a]
        if index_a == 0 or index_a == len(commands) - 1:
            index_b = index_a
        elif distance < 0:
            index_b = index_a + 1
        else:
            index_b = index_a - 1
        if index_a == index_b:
            return commands[index_a]
        x_a, y_a = cum_time[index_a], commands[index_a]
        x_b, y_b = cum_time[index_b], commands[index_b]
        portion_a = (x_b - elapsed_time) / (x_b - x_a)
        portion_b = (elapsed_time - x_a) / (x_b - x_a)
        return y_a * portion_a + y_b * portion_b
