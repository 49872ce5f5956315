from acmpc_tpu_torch.config.schema import AgentConfig, PIDConfig, load_config, load_raw

__all__ = ["AgentConfig", "PIDConfig", "load_config", "load_raw"]
