from acmpc_tpu_torch.dynamics.spatial_bicycle import SpatialBicycleModel, linearise, s2t, t2s
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams

__all__ = ["SpatialBicycleModel", "VehicleParams", "linearise", "s2t", "t2s"]
