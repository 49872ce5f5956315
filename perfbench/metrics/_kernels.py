"""Device time of a kernel in the traced run's profiled stretch."""


def per_launch(ctx, fragment: str):
    """(mean seconds a launch, launches) of the kernels whose name holds
    ``fragment``; None where none ran."""
    table = (ctx["trace"] or {}).get("kernels") or {}
    rows = [v for k, v in table.items() if fragment in k]
    n = sum(r[1] for r in rows)
    return (sum(r[0] for r in rows) / n, n) if n else None
