"""Closed-loop sweeps and on-card measurement scripts of the port."""

from acmpc_tpu_torch.bench.lap_sweep import CarState, LapSweep, SweepGrid

__all__ = ["CarState", "LapSweep", "SweepGrid"]
