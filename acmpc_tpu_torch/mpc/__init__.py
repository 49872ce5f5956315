from acmpc_tpu_torch.mpc.control_qp import assemble_control_qp, solve_control_qp
from acmpc_tpu_torch.mpc.spatial_mpc import MPCConfig, MPCState, SpatialMPC, build_mpc

__all__ = [
    "MPCConfig",
    "MPCState",
    "SpatialMPC",
    "assemble_control_qp",
    "build_mpc",
    "solve_control_qp",
]
