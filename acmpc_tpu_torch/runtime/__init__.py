from acmpc_tpu_torch.runtime.commands import (
    TemporalCommandInterpolator,
    TemporalCommandSelector,
)

__all__ = ["TemporalCommandInterpolator", "TemporalCommandSelector"]
