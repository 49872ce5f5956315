from acmpc_tpu_torch.config.schema import AgentConfig, load_config, load_raw

__all__ = ["AgentConfig", "load_config", "load_raw"]
