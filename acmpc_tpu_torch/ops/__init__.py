"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the plain-PyTorch linear-algebra ops of the speed profile
and the SPD inverse."""

from acmpc_tpu_torch.ops.spd_inverse import spd_inverse
from acmpc_tpu_torch.ops.tridiag import tridiag_matvec, tridiag_solve
from acmpc_tpu_torch.ops.tridiag_sharded import tridiag_solve_sharded

__all__ = [
    "spd_inverse",
    "tridiag_matvec",
    "tridiag_solve",
    "tridiag_solve_sharded",
]
