"""The least time of one ADMM chunk launch on an H100: each input read
once and each output written once, against the fp32 operations of the
active scenarios' iterations. With the box block (n_b = n of the m rows)
the operator is W_s (n, n + m_d), A_d (m_d, n) and the diagonal g."""

from perfbench.metrics._peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S


def per_iteration_flops(n: int, m: int, n_b: int = 0) -> int:
    m_d = m - n_b
    return 2 * n * (n + m_d) + 2 * m_d * n + 12 * m + 4 * n + (4 * n if n_b else 0)


def chunk_bound(n: int, m: int, n_iters: int, n_active: int, batch: int, masked: bool, n_b: int = 0):
    """(seconds, "bytes" | "operations") of one chunk call."""
    m_d = m - n_b
    # W, A[, g], c0, rho, l, u
    operator = 4 * (n * (n + m_d) + m_d * n + (n if n_b else 0) + n + 3 * m)
    iterates = 4 * (n + 2 * m)  # x, z, y
    n_bytes = n_active * operator + 2 * batch * iterates + (batch if masked else 0)
    flops = n_active * n_iters * per_iteration_flops(n, m, n_b)
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")
