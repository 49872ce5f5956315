from acmpc_tpu_torch.mapping.map_maker import MapMaker

__all__ = ["MapMaker"]
