"""Scenario and horizon parallelism over ``torch.distributed`` ranks."""

from acmpc_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    scenario_sharding,
    sharded_get_control,
)

__all__ = ["Mesh", "make_mesh", "scenario_sharding", "sharded_get_control"]
