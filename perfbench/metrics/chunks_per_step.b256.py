"""ADMM chunk launches a batched step (each launch covers every lane),
from the port's launch counters over the traced run's first stretch."""


def read(ctx):
    c = (ctx["trace"] or {}).get("counters") or {}
    return c["chunks"] / c["requests"] if c.get("requests") else None
