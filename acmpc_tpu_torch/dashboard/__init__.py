from acmpc_tpu_torch.dashboard.server import Dashboard

__all__ = ["Dashboard"]
