from acmpc_tpu_torch.runtime.commands import (
    TemporalCommandInterpolator,
    TemporalCommandSelector,
)
from acmpc_tpu_torch.runtime.pid import PID, BrakePID, SteeringPID, ThrottlePID
from acmpc_tpu_torch.runtime.agent import Agent
from acmpc_tpu_torch.runtime.controller import Controller
from acmpc_tpu_torch.runtime.mailbox import Mailbox
from acmpc_tpu_torch.runtime.sim import SimulatorInterface, SyntheticSimulator
from acmpc_tpu_torch.runtime.worker import WorkerThread

__all__ = [
    "PID",
    "Agent",
    "BrakePID",
    "Controller",
    "Mailbox",
    "SimulatorInterface",
    "SteeringPID",
    "SyntheticSimulator",
    "TemporalCommandInterpolator",
    "TemporalCommandSelector",
    "ThrottlePID",
    "WorkerThread",
]
