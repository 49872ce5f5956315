"""Share of the ADMM chunk's least time (``_chunk_bound``) that its
launches take, for the cell's control QP shapes."""

from perfbench.metrics._chunk_bound import chunk_bound
from perfbench.metrics._kernels import per_launch

ITERATIONS = 25  # a chunk of the MPC's solves (check_every)


def admm_chunk(ctx):
    seen = per_launch(ctx, "admm_chunk")
    if seen is None:
        return None
    s = ctx["cell"].shapes()
    bound, _ = chunk_bound(s["n"], s["m"], ITERATIONS, s["batch"], s["batch"], False, s["n"])
    return 100.0 * bound / seen[0]
