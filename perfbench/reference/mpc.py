"""Plain reference of one MPC control step: the window's waypoints, the
exact speed profile, the spatial bicycle linearisation, the control QP,
an ADMM solve of it and the command extraction.

Written from the published method (ac-mpc's spatial MPC, OSQP's ADMM,
Stellato et al. 2020) in plain PyTorch: no kernel, no capture, no batch
trick. It imports nothing of the program. Every function takes any
leading batch dimensions and computes in the dtype of its inputs; the
harness runs it in float64 to judge the program, and in float32 with
the ADMM iterations' products rounded to TF32 (``Arith(tf32=True)``) as
the control that a lower precision has to fail.

The program's answer is judged by the optimality conditions of the QP
the reference builds from the same window: its primal and dual
residuals, unscaled, against the tolerances the configuration states
(``kkt_ratio``). A ratio at or below 1 is a solve to tolerance.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NX, NU = 3, 2
BIG = 1e30
EPS = 1e-12
STATUS_SOLVED, STATUS_INACCURATE = 1, 3


class Arith:
    """Matrix products of the reference: exact in the inputs' dtype, or
    with each operand rounded to TF32's 10-bit mantissa first (what a
    tensor core takes from float32 with TF32 on)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def round(self, a: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return a
        if a.dtype != torch.float32:
            raise ValueError("TF32 rounding takes float32 operands")
        bits = a.contiguous().view(torch.int32)
        bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def mv(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(a, v[..., None])[..., 0]


EXACT = Arith(False)


@dataclasses.dataclass(frozen=True)
class Control:
    """One control block of the configuration (racing.control or
    mapping.control) with the vehicle numbers the QP needs."""

    horizon: int
    step_cost: tuple
    r_term: tuple
    final_cost: tuple
    v_min: float
    v_max: float
    a_min: float
    a_max: float
    ay_max: float
    ki_min: float
    end_velocity: float
    wheelbase: float
    margin: float
    kappa_max: float
    # the solver's settings (the program's ADMM settings for the MPC)
    sigma: float
    rho: float
    alpha: float
    eps_abs: float
    eps_rel: float
    inaccurate_factor: float
    max_iter: int
    check_every: int
    scaling_iters: int

    @classmethod
    def from_config(cls, config: dict, block: str) -> "Control":
        c = config["agent"][block]["control"]
        sp = c["speed_profile_constraints"]
        v = config["agent"]["vehicle"]
        s = config["solver"]
        max_wheel = math.radians(v["max_steering_deg"]) / v["steering_ratio"]
        return cls(
            horizon=c["horizon"],
            step_cost=tuple(c["step_cost"]),
            r_term=tuple(c["r_term"]),
            final_cost=tuple(c["final_cost"]),
            v_min=sp["v_min"], v_max=sp["v_max"], a_min=sp["a_min"], a_max=sp["a_max"],
            ay_max=sp["ay_max"], ki_min=sp["ki_min"], end_velocity=sp["end_velocity"],
            wheelbase=v["wheelbase"],
            margin=v["width"] / 2.0,
            kappa_max=math.tan(max_wheel) / v["wheelbase"],
            **{k: s[k] for k in (
                "sigma", "rho", "alpha", "eps_abs", "eps_rel", "inaccurate_factor",
                "max_iter", "check_every", "scaling_iters",
            )},
        )


def wrap(angle):
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def waypoints(window: torch.Tensor) -> dict:
    """(..., H, 3) of [x, y, width] -> the path's H-1 waypoints: position,
    heading of the leaving segment, curvature, segment length, width."""
    cur, nxt = window[..., :-1, :2], window[..., 1:, :2]
    prev = torch.cat([window[..., -1:, :2], window[..., :-2, :2]], dim=-2)
    ahead, behind = nxt - cur, cur - prev
    psi = torch.atan2(ahead[..., 1], ahead[..., 0])
    ds = torch.sqrt(ahead[..., 0] ** 2 + ahead[..., 1] ** 2)
    kappa = wrap(psi - torch.atan2(behind[..., 1], behind[..., 0])) / (ds + EPS) + EPS
    kappa = torch.cat([kappa[..., 1:2], kappa[..., 1:]], dim=-1)
    return dict(x=window[..., :-1, 0], y=window[..., :-1, 1], psi=psi, kappa=kappa,
                ds=ds, width=window[..., 1:, 2])


def speed_profile(path: dict, ctl: Control, v_cap, localised):
    """The speed QP's exact solution: the curvature and runtime caps,
    then the forward (a_max) and backward (a_min) recurrences, one
    waypoint at a time. Returns (velocities, feasible)."""
    kappa, ds = path["kappa"], path["ds"]
    v_cap = torch.as_tensor(v_cap, dtype=kappa.dtype, device=kappa.device)[..., None]
    localised = torch.as_tensor(localised, device=kappa.device)[..., None]
    k = torch.abs(kappa)
    dyn = torch.where(k < ctl.ki_min, v_cap, torch.sqrt(ctl.ay_max / (k + EPS)))
    hi = torch.clamp(torch.minimum(dyn, v_cap), min=ctl.v_min) + 2.0
    hi = torch.cat([hi[..., :-1], torch.full_like(hi[..., -1:], ctl.end_velocity)], dim=-1)
    hi = torch.where(localised, torch.ones_like(kappa) * v_cap, hi)
    n = kappa.shape[-1]
    fwd, bwd = [hi[..., 0]], [hi[..., n - 1]]
    for i in range(1, n):
        fwd.append(torch.minimum(hi[..., i], fwd[-1] + 2.0 * ds[..., i - 1] * ctl.a_max))
    for i in range(n - 2, -1, -1):
        bwd.append(torch.minimum(hi[..., i], bwd[-1] - 2.0 * ds[..., i] * ctl.a_min))
    v = torch.minimum(torch.stack(fwd, dim=-1), torch.stack(bwd[::-1], dim=-1))
    return v, torch.all(v >= ctl.v_min - 1e-4, dim=-1)


def control_qp(path: dict, v: torch.Tensor, ctl: Control, offset):
    """(P, q, A, l, u) of the horizon QP: variables [x_0..x_n | u_0..u_n-1]
    with x = (e_y, e_psi, t), u = (v, kappa); rows: the dynamics as
    equalities, then the identity over every variable (track limits on
    e_y, the pinned initial e_y, the input box with 0.1 m/s of slack)."""
    x, ds, kappa = path["x"], path["ds"], path["kappa"]
    lead, n, dt, dev = x.shape[:-1], x.shape[-1], x.dtype, x.device
    n_var, n_eq = NX * (n + 1) + NU * n, NX * (n + 1)
    zero = torch.zeros_like(ds)

    # linearised spatial bicycle about (v, kappa), time row in reference units
    A_k = torch.zeros(*lead, n, NX, NX, dtype=dt, device=dev)
    A_k[..., 0, 0] = 1.0
    A_k[..., 0, 1] = ds
    A_k[..., 1, 0] = -(kappa ** 2) * ds
    A_k[..., 1, 1] = 1.0
    A_k[..., 2, 0] = -kappa / (v * ds + EPS)
    A_k[..., 2, 2] = 1.0
    B_k = torch.zeros(*lead, n, NX, NU, dtype=dt, device=dev)
    B_k[..., 1, 1] = ds
    B_k[..., 2, 0] = -1.0 / (v ** 2 * ds + EPS)
    f = torch.stack([zero, zero, 1.0 / (v * ds + EPS)], dim=-1)
    u_ref = torch.stack([v, kappa], dim=-1)

    A_eq = torch.zeros(*lead, n_eq, n_var, dtype=dt, device=dev)
    A_eq[..., range(n_eq), range(n_eq)] = -1.0
    for k in range(n):
        r = NX * (k + 1)
        A_eq[..., r:r + NX, NX * k:NX * k + NX] = A_k[..., k, :, :]
        cb = n_eq + NU * k
        A_eq[..., r:r + NX, cb:cb + NU] = B_k[..., k, :, :]
    rhs = (B_k @ u_ref[..., None])[..., 0] - f

    offset = torch.as_tensor(offset, dtype=dt, device=dev)
    # the car at (offset, 0) heading +y in the ego frame, against waypoint 0
    e_y0 = torch.cos(path["psi"][..., 0]) * (0.0 - path["y"][..., 0]) - torch.sin(
        path["psi"][..., 0]) * (offset - x[..., 0])
    e_psi0 = wrap(math.pi / 2 - path["psi"][..., 0])
    x_init = torch.stack([e_y0, e_psi0, torch.zeros_like(e_y0)], dim=-1)
    eq = torch.cat([-x_init, rhs.reshape(*lead, NX * n)], dim=-1)

    lo = torch.full((*lead, n_var), -BIG, dtype=dt, device=dev)
    hi = torch.full((*lead, n_var), BIG, dtype=dt, device=dev)
    lo[..., 0], hi[..., 0] = e_y0, e_y0
    half = path["width"] / 2.0 - ctl.margin
    lo[..., NX:n_eq:NX], hi[..., NX:n_eq:NX] = -half, half
    lo[..., n_eq::2], hi[..., n_eq::2] = ctl.v_min - 0.1, ctl.v_max + 0.1
    lo[..., n_eq + 1::2], hi[..., n_eq + 1::2] = -ctl.kappa_max, ctl.kappa_max

    eye = torch.eye(n_var, dtype=dt, device=dev).expand(*lead, n_var, n_var)
    A = torch.cat([A_eq, eye], dim=-2)
    l = torch.cat([eq, lo], dim=-1)
    u = torch.cat([eq, hi], dim=-1)
    p_diag = torch.tensor(
        list(ctl.step_cost) * n + list(ctl.final_cost) + list(ctl.r_term) * n, dtype=dt, device=dev)
    P = torch.diag_embed(p_diag.expand(*lead, n_var))
    r_term = torch.tensor(list(ctl.r_term) * n, dtype=dt, device=dev)
    q = torch.cat([torch.zeros(*lead, n_eq, dtype=dt, device=dev),
                   -r_term * u_ref.reshape(*lead, NU * n)], dim=-1)
    return P, q, A, l, u


def build(window, ctl: Control, v_cap, localised, offset=0.0):
    """The path, its speed profile and feasibility, and the QP of one
    window (any leading batch dims)."""
    path = waypoints(window)
    v, feasible = speed_profile(path, ctl, v_cap, localised)
    return path, v, feasible, control_qp(path, v, ctl, offset)


def kkt_ratio(qp, x, y, ctl: Control):
    """The worst of the unscaled primal and dual residuals of (x, y) on
    the QP, each over its tolerance eps_abs + eps_rel * scale; (...,)."""
    P, q, A, l, u = qp
    Ax = (A @ x[..., None])[..., 0]
    z = torch.minimum(torch.maximum(Ax, l), u)
    r_prim = torch.amax(torch.abs(Ax - z), dim=-1)
    Px = (P @ x[..., None])[..., 0]
    Aty = (A.transpose(-1, -2) @ y[..., None])[..., 0]
    r_dual = torch.amax(torch.abs(Px + q + Aty), dim=-1)
    inf = lambda t: torch.amax(torch.abs(t), dim=-1)  # noqa: E731
    eps_p = ctl.eps_abs + ctl.eps_rel * torch.maximum(inf(Ax), inf(z))
    eps_d = ctl.eps_abs + ctl.eps_rel * torch.maximum(torch.maximum(inf(Px), inf(Aty)), inf(q))
    return torch.maximum(r_prim / eps_p, r_dual / eps_d)


def admm(qp, ctl: Control, ar: Arith = EXACT, x0=None, y0=None):
    """OSQP's relaxed ADMM with a fixed rho on a batch of QPs (B, ...):
    Ruiz equilibration, one inverse of the x-update matrix, residual
    checks every ``check_every`` iterations. ``ar`` takes the iterations'
    products; the x-update matrix and its inverse are formed exact in the
    inputs' dtype (TF32 there leaves K K^-1 - I too far from 0 at horizon
    100 for the iterations to converge). Returns (x, y, status,
    iterations); status 1 solved, 3 solved inaccurate, 0 not solved."""
    P, q, A, l, u = qp
    B, m, n = A.shape
    dt, dev = q.dtype, q.device
    d = torch.ones_like(q)
    e = torch.ones(B, m, dtype=dt, device=dev)
    c = torch.ones(B, dtype=dt, device=dev)
    Ps, qs, As = P, q, A
    for _ in range(ctl.scaling_iters):
        col = torch.maximum(torch.amax(torch.abs(Ps), -2), torch.amax(torch.abs(As), -2))
        dd = 1.0 / torch.sqrt(torch.clamp(col, 1e-4, 1e4))
        ee = 1.0 / torch.sqrt(torch.clamp(torch.amax(torch.abs(As), -1), 1e-4, 1e4))
        Ps = Ps * dd[:, :, None] * dd[:, None, :]
        qs = qs * dd
        As = As * ee[:, :, None] * dd[:, None, :]
        d, e = d * dd, e * ee
        g = 1.0 / torch.clamp(torch.maximum(torch.mean(torch.amax(torch.abs(Ps), -2), -1),
                                            torch.amax(torch.abs(qs), -1)), 1e-4, 1e4)
        Ps, qs, c = Ps * g[:, None, None], qs * g[:, None], c * g
    ls = e * torch.clamp(l, -BIG, BIG)
    us = e * torch.clamp(u, -BIG, BIG)
    loose = (ls <= -BIG / 1e4) & (us >= BIG / 1e4)
    rho = torch.where((us - ls) < 1e-6, ctl.rho * 1e3, torch.where(loose, ctl.rho * 1e-6, ctl.rho))
    eye = torch.eye(n, dtype=dt, device=dev)
    K = Ps + ctl.sigma * eye + (As.transpose(-1, -2) * rho[:, None, :]) @ As
    L = torch.linalg.cholesky(K)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Ki = Li.transpose(-1, -2) @ Li
    for _ in range(2):  # Newton steps on the inverse, where they contract
        R = eye - K @ Ki
        ok = torch.sum(R * R, dim=(-2, -1)) < 1.0
        Ki = torch.where(ok[:, None, None], Ki + Ki @ R, Ki)
    c0 = -(Ki @ qs[..., None])[..., 0]
    KiAt = Ki @ As.transpose(-1, -2)

    x = torch.zeros_like(qs) if x0 is None else x0 / d
    y = torch.zeros_like(ls) if y0 is None else c[:, None] * y0 / e
    z = torch.minimum(torch.maximum(ar.mv(As, x), ls), us)
    status = torch.zeros(B, dtype=torch.int32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    a = ctl.alpha
    for it in range(0, ctl.max_iter, ctl.check_every):
        x_, z_, y_ = x, z, y
        for _ in range(ctl.check_every):
            xt = ctl.sigma * ar.mv(Ki, x_) + ar.mv(KiAt, rho * z_ - y_) + c0
            zt = ar.mv(As, xt)
            zr = a * zt + (1 - a) * z_
            zn = torch.minimum(torch.maximum(zr + y_ / rho, ls), us)
            y_ = y_ + rho * (zr - zn)
            x_, z_ = a * xt + (1 - a) * x_, zn
        keep = done[:, None]
        x, z, y = torch.where(keep, x, x_), torch.where(keep, z, z_), torch.where(keep, y, y_)
        Axu, zu = ar.mv(As, x) / e, z / e
        Pxu = ar.mv(Ps, x) / d / c[:, None]
        Atyu = ar.mv(As.transpose(-1, -2), y) / d / c[:, None]
        qu = qs / d / c[:, None]
        inf = lambda t: torch.amax(torch.abs(t), dim=-1)  # noqa: E731
        rp, rd = inf(Axu - zu), inf(Pxu + Atyu + qu)
        ep = ctl.eps_abs + ctl.eps_rel * torch.maximum(inf(Axu), inf(zu))
        ed = ctl.eps_abs + ctl.eps_rel * torch.maximum(torch.maximum(inf(Pxu), inf(Atyu)), inf(qu))
        conv = (rp <= ep) & (rd <= ed) & torch.isfinite(rp) & torch.isfinite(rd)
        near = (rp <= ctl.inaccurate_factor * ep) & (rd <= ctl.inaccurate_factor * ed)
        new = ~done
        status = torch.where(new & conv, STATUS_SOLVED,
                             torch.where(new & near, STATUS_INACCURATE,
                                         torch.where(new, 0, status))).to(torch.int32)
        iters = torch.where(new, it + ctl.check_every, iters).to(torch.int32)
        done = done | conv
        if bool(done.all()):
            break
    return x * d, y * e / c[:, None], status, iters


def extract(x: torch.Tensor, path: dict, ctl: Control):
    """The command plan of a solution x: (velocities, steering angles),
    the predicted positions along the path and the plan's clock."""
    n = path["x"].shape[-1]
    u = x[..., -n * NU:]
    vel, delta = u[..., 0::2], torch.atan(u[..., 1::2] * ctl.wheelbase)
    states = x[..., : n * NX].reshape(*x.shape[:-1], n, NX)
    e_y = states[..., 0]
    pred = torch.stack([path["x"] - e_y * torch.sin(path["psi"]),
                        path["y"] + e_y * torch.cos(path["psi"])], dim=-1)
    step = path["ds"] * (1.0 - path["kappa"] * e_y) / torch.clamp(vel, min=0.1)
    clock = torch.cat([torch.zeros_like(step[..., :1]), torch.cumsum(step[..., :-1], dim=-1)], dim=-1)
    return torch.stack([vel, delta], dim=-2), pred, clock
