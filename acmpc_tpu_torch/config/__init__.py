from acmpc_tpu_torch.config.schema import (
    AgentConfig,
    LocalisationConfig,
    PIDConfig,
    PerceptionConfig,
    load_config,
    load_raw,
)

__all__ = [
    "AgentConfig",
    "LocalisationConfig",
    "PIDConfig",
    "PerceptionConfig",
    "load_config",
    "load_raw",
]
