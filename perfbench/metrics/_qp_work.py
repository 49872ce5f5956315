"""The fp32 operations a control QP needs, counted from its shapes and
its iterations, whatever implements them: forming the x-update matrix
K = P + sigma I + A_d' diag(rho) A_d + diag(rho g^2) and one Cholesky
factorisation of it per solve, then each ADMM iteration actually run at
the box block's count."""

from perfbench.metrics._chunk_bound import per_iteration_flops


def factor_flops(n: int, m: int) -> float:
    m_d = m - n
    return 2.0 * m_d * n * n + n ** 3 / 3.0


def qp_flops(n: int, m: int, solves: int, iterations: int) -> float:
    return solves * factor_flops(n, m) + iterations * per_iteration_flops(n, m, n)
