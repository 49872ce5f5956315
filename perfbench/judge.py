"""The comparisons that decide ``correct``: the program's answers, read
after the window, against what the plain reference works out again from
the same inputs.

``qp_ratio`` judges a control step: the reference builds the QP of the
window the step was given and measures the program's primal and dual
solution against its optimality conditions, and the published plan
against the plan of that solution, each over the solver's tolerance
(eps_abs + eps_rel * scale). The configuration states the limit: a
solve is accepted up to ``inaccurate_factor`` times the tolerance.
"""

from __future__ import annotations

import torch

from perfbench.reference import mpc as R

BLOCK = 512  # QPs the reference builds at once


def worst(*values: float) -> float:
    """The largest of the values, and NaN, should any be NaN: an answer
    that is not a number is the worst there is."""
    vals = [float(v) for v in values]
    return float("nan") if any(v != v for v in vals) else max(vals)


def _rel(a, b, ctl) -> torch.Tensor:
    """|a - b| over eps_abs + eps_rel * |b|, the worst entry of each row."""
    gap = torch.abs(a - b).flatten(1)
    scale = torch.amax(torch.abs(b).flatten(1), dim=1)
    return torch.amax(gap, dim=1) / (ctl.eps_abs + ctl.eps_rel * scale)


def plan_ratio(path, x, plan, ctl) -> torch.Tensor:
    """How far a published plan (projected (B, 2, n), clock (B, n),
    prediction (B, n, 2)) lies from the plan of the solution x: speeds,
    steering angles, clock and positions each against its own scale."""
    proj, pred, clock = R.extract(x, path, ctl)
    parts = [_rel(plan["projected"][:, 0], proj[:, 0], ctl), _rel(plan["projected"][:, 1], proj[:, 1], ctl),
             _rel(plan["clock"], clock, ctl), _rel(plan["prediction"], pred, ctl)]
    return torch.stack(parts).amax(dim=0)


def qp_ratios(windows, v_caps, localised, x, y, plan, ctl, dtype=torch.float64):
    """The worst of the KKT and plan ratios of each solved step, in
    blocks; all inputs stacked over the steps (leading axis)."""
    out = []
    for s in range(0, windows.shape[0], BLOCK):
        sl = slice(s, s + BLOCK)
        path, v, feasible, qp = R.build(windows[sl].to(dtype), ctl, v_caps[sl].to(dtype), localised[sl])
        ratio = R.kkt_ratio(qp, x[sl].to(dtype), y[sl].to(dtype), ctl)
        ratio = torch.maximum(ratio, plan_ratio(path, x[sl].to(dtype), {k: p[sl].to(dtype) for k, p in plan.items()}, ctl))
        # a step whose speed profile the reference finds infeasible has no
        # plan to judge; the program must not have published one
        ratio = torch.where(feasible, ratio, torch.full_like(ratio, float("inf")))
        out.append(ratio)
    return torch.cat(out)


def control_qp_ratios(windows, v_caps, localised, ctl, ar=R.Arith(tf32=True)):
    """The control in the program's place: the reference's own step on the
    same windows in float32, from a cold start, judged as the program is.
    The ADMM iterations' products take TF32 (the chunk on tensor cores);
    the factorisation and the inverse stay float32 (``R.admm``)."""
    out = []
    for s in range(0, windows.shape[0], BLOCK):
        sl = slice(s, s + BLOCK)
        path, _, _, qp = R.build(windows[sl].float(), ctl, v_caps[sl].float(), localised[sl])
        x, y, _, _ = R.admm(qp, ctl, ar)
        proj, pred, clock = R.extract(x, path, ctl)
        plan = {"projected": proj, "clock": clock, "prediction": pred}
        out.append(qp_ratios(windows[sl], v_caps[sl], localised[sl], x, y, plan, ctl))
    return torch.cat(out)
