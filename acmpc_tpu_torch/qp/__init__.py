from acmpc_tpu_torch.qp.admm import ADMMConfig, QPSolution, solve_box_qp
from acmpc_tpu_torch.qp.batched import solve_box_qp_batched

__all__ = ["ADMMConfig", "QPSolution", "solve_box_qp", "solve_box_qp_batched"]
