"""ADMM chunk launches a solve, from the port's launch counters (settled
after the replays) over the traced run's first stretch."""


def read(ctx):
    c = (ctx["trace"] or {}).get("counters") or {}
    return c["chunks"] / c["qp_solves"] if c.get("qp_solves") else None
