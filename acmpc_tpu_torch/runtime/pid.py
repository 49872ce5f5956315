"""First-party PID controllers for the actuator layer.

The port's copy of ``acmpc_tpu/runtime/pid.py``: per-call setpoint,
sample-time gating, output clamping, derivative-on-measurement, and the
brake controller's 1 m/s dead zone and sign flip.

This is deliberately host-side Python: PIDs run once per frame on scalars
between device launches; putting them on the card would add a transfer
round trip for three multiplies.
"""

from __future__ import annotations

import time
from typing import Optional

from acmpc_tpu_torch.config.schema import PIDConfig

BRAKE_DEAD_ZONE_MS = 1.0

CONTROL_LIMITS = {
    "steering": (-1.0, 1.0),
    "throttle": (0.0, 1.0),
    "brake": (-1.0, 0.0),
}


class PID:
    """Classic PID with derivative-on-measurement and integral clamping."""

    def __init__(
        self,
        kp: float,
        ki: float,
        kd: float,
        sample_time: float = 0.01,
        output_limits: tuple = (None, None),
    ):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.sample_time = sample_time
        self.output_limits = output_limits
        self.reset()

    def reset(self):
        self._integral = 0.0
        self._last_input: Optional[float] = None
        self._last_output: Optional[float] = None
        self._last_time: Optional[float] = None

    def _clamp(self, value: float) -> float:
        lo, hi = self.output_limits
        if hi is not None and value > hi:
            return hi
        if lo is not None and value < lo:
            return lo
        return value

    def __call__(self, input_: float, setpoint: float, now: float = None) -> float:
        now = time.monotonic() if now is None else now
        dt = (now - self._last_time) if self._last_time is not None else 1e-16
        if (
            self.sample_time is not None
            and dt < self.sample_time
            and self._last_output is not None
        ):
            return self._last_output

        error = setpoint - input_
        d_input = (
            input_ - self._last_input if self._last_input is not None else 0.0
        )

        proportional = self.kp * error
        self._integral = self._clamp(self._integral + self.ki * error * dt)
        derivative = -self.kd * d_input / dt if dt > 0 else 0.0

        output = self._clamp(proportional + self._integral + derivative)
        self._last_input = input_
        self._last_output = output
        self._last_time = now
        return output


class _ControlPID:
    """Configured PID with actuator-range clamping."""

    _limits_key = ""

    def __init__(self, cfg: PIDConfig):
        self._pid = PID(
            cfg.proportional,
            cfg.integral,
            cfg.derivative,
            sample_time=cfg.sampling_interval_s,
            output_limits=CONTROL_LIMITS[self._limits_key],
        )

    def reset(self):
        self._pid.reset()

    def __call__(self, current: float, target: float, now: float = None) -> float:
        return self._pid(current, target, now)


class SteeringPID(_ControlPID):
    _limits_key = "steering"


class ThrottlePID(_ControlPID):
    _limits_key = "throttle"


class BrakePID(_ControlPID):
    """Brake: 1 m/s dead zone on the target, negated output so the
    actuator range is [0, 1]."""

    _limits_key = "brake"

    def __call__(self, current: float, target: float, now: float = None) -> float:
        return -1.0 * super().__call__(current, target + BRAKE_DEAD_ZONE_MS, now)
