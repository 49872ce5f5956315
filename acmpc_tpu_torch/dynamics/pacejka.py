"""Dynamic bicycle model with Pacejka lateral tyres (offline validation).

Counterpart of ``acmpc_tpu/dynamics/pacejka.py``: a 6-state (x, y, yaw,
vx, vy, yaw_rate) model with Pacejka magic-formula lateral forces and
fitted longitudinal motor/brake/friction curves, used for offline
validation and rollouts, not in the control loop. ``x_dot`` is a pure
tensor function that broadcasts over leading dimensions; ``rollout`` (a
``lax.scan`` in JAX) is a loop on the device with no host read; the curves
are fitted by Gauss-Newton least squares, the Jacobian by
``torch.func.jacrev`` where JAX takes ``jax.jacobian``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acmpc_tpu_torch.device import resolve_device

# measured (speed, pedal, force) samples the curves are fitted to, with
# the forces converted from N to kN so that kN / tonne = m/s^2 (full
# throttle ~5.7 m/s^2, full brake ~ -16 m/s^2), as in the JAX package
ACCELERATION_DATA = np.array(
    [
        [0.0, 1.0, 6612],
        [27.78, 1.0, 5684],
        [55.56, 1.0, 1160],
        [55.56, 0.0, -2436],
        [27.78, 0.0, -812],
        [11.11, 0.0, -238],
    ]
).T
BRAKING_DATA = np.array(
    [
        [55.56, 0.0, -2436],
        [27.78, 0.0, -812],
        [11.11, 0.0, -238],
        [55.56, -1.0, -18908],
        [27.78, -1.0, -17748],
        [11.11, -1.0, -17168],
    ]
).T
ACCELERATION_DATA[2] /= 1000.0
BRAKING_DATA[2] /= 1000.0


def long_force(data, params):
    """(cm1 - cm2 v - cm3 v^2) u - cf1 - cf2 v - cf3 v^2."""
    cm1, cm2, cm3, cf1, cf2, cf3 = params
    v, u = data[0], data[1]
    return (cm1 - cm2 * v - cm3 * v**2) * u - cf1 - cf2 * v - cf3 * v**2


def fit_long_force(data: np.ndarray, n_iters: int = 100, device=None) -> np.ndarray:
    """Gauss-Newton least squares for the longitudinal curve on ``device``
    (CUDA unless given): three steps, though the model is linear in its
    parameters, so the first is exact. ``n_iters`` is unused, as in the
    JAX package."""
    device = resolve_device(device)
    xy = torch.as_tensor(data[:2], dtype=torch.float32, device=device)
    target = torch.as_tensor(data[2], dtype=torch.float32, device=device)

    def residual(p):
        return long_force(xy, p) - target

    p = torch.zeros(6, device=device)
    for _ in range(3):
        J = torch.func.jacrev(residual)(p)
        r = residual(p)
        p = p - torch.linalg.lstsq(J, r[:, None]).solution[:, 0]
    return p.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class PacejkaParams:
    """Tyre and body parameters."""

    F_z0: float = 3.0
    Bf: float = 9.62
    Cf: float = 2.59
    Df: float = 4.120
    Ef: float = 1.0
    epsf: float = -0.0813
    Br: float = 8.62
    Cr: float = 2.65
    Dr: float = 4.617
    Er: float = 1.0
    epsr: float = -0.1263
    mass: float = 1.160
    Iz: float = 1.260
    g: float = 9.81
    h: float = 0.35
    lf: float = 1.51
    lr: float = 1.388
    brake_bias: float = 0.7

    @property
    def F_zf(self) -> float:
        return self.mass * self.g * self.lr / (self.lr + self.lf)

    @property
    def F_zr(self) -> float:
        return self.mass * self.g * self.lf / (self.lr + self.lf)


class DynamicBicycleModel:
    """The model on ``device`` (CUDA unless given): the curves are fitted
    there, and ``predict_next_state`` and ``rollout`` run there."""

    def __init__(self, params: PacejkaParams | None = None, device=None):
        self.p = params or PacejkaParams()
        self.device = resolve_device(device)
        accel = fit_long_force(ACCELERATION_DATA, device=self.device)
        brake = fit_long_force(BRAKING_DATA, device=self.device)
        self.Cm1, self.Cm2, self.Cm3 = (float(v) for v in accel[:3])
        self.Cb1, self.Cb2, self.Cb3 = (float(v) for v in brake[:3])
        self.Cfric1, self.Cfric2, self.Cfric3 = (float(v) for v in brake[3:])

    def _pacejka(self, alpha, B, C, D, E, eps, F_z):
        p = self.p
        load = D * (1 + eps * F_z / p.F_z0) * F_z / p.F_z0
        slip = B * alpha
        one = torch.ones_like(slip)
        return load * torch.sin(
            C * torch.atan2(slip - E * (slip - torch.atan2(slip, one)), one)
        )

    def x_dot(self, state: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
        """Continuous-time derivative; broadcasts over leading dims."""
        p = self.p
        delta, acc = control[..., 0], control[..., 1]
        yaw = state[..., 2]
        vx, vy, r = state[..., 3], state[..., 4], state[..., 5]

        alpha_f = -torch.atan((r * p.lf + vy) / (vx + 1e-3)) + delta
        alpha_r = torch.atan((r * p.lr - vy) / (vx + 1e-3))

        F_fy = self._pacejka(alpha_f, p.Bf, p.Cf, p.Df, p.Ef, p.epsf, p.F_zf)
        F_ry = self._pacejka(alpha_r, p.Br, p.Cr, p.Dr, p.Er, p.epsr, p.F_zr)

        F_fric = -self.Cfric1 - self.Cfric2 * vx - self.Cfric3 * vx**2
        brake_curve = self.Cb1 - self.Cb2 * vx - self.Cb3 * vx**2
        motor_curve = self.Cm1 - self.Cm2 * vx - self.Cm3 * vx**2
        braking = torch.clamp(acc, max=0.0)
        F_rx = brake_curve * (1 - p.brake_bias) * braking + motor_curve * torch.clamp(acc, min=0.0)
        F_fx = brake_curve * p.brake_bias * braking

        return torch.stack(
            [
                vx * torch.cos(yaw) - vy * torch.sin(yaw),
                vx * torch.sin(yaw) + vy * torch.cos(yaw),
                r,
                (F_rx + F_fx + F_fric - F_fy * torch.sin(delta)) / p.mass + vy * r,
                (F_ry + F_fy * torch.cos(delta)) / p.mass - vx * r,
                (F_fy * p.lf * torch.cos(delta) - F_ry * p.lr) / p.Iz,
            ],
            dim=-1,
        )

    def predict_next_state(self, state, control, dt: float = 0.05):
        """Euler step; returns (next state, derivative)."""
        state = torch.as_tensor(state, dtype=torch.float32, device=self.device)
        control = torch.as_tensor(control, dtype=torch.float32, device=self.device)
        xd = self.x_dot(state, control)
        return state + xd * dt, xd

    def rollout(self, state0, controls, dt: float = 0.05) -> torch.Tensor:
        """Integrate a control sequence (T, 2) into a trajectory (T, 6),
        with no host read."""
        s = torch.as_tensor(state0, dtype=torch.float32, device=self.device)
        controls = torch.as_tensor(controls, dtype=torch.float32, device=self.device)
        traj = []
        for u in controls:
            s, _ = self.predict_next_state(s, u, dt)
            traj.append(s)
        return torch.stack(traj)
