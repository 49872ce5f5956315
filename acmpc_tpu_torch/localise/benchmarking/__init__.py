from acmpc_tpu_torch.localise.benchmarking.benchmark import BenchmarkLocalisation
from acmpc_tpu_torch.localise.benchmarking.recording import (
    LocalisationRecorder,
    LocalisationRecording,
)
from acmpc_tpu_torch.localise.benchmarking.tracker import LocalisationTracker

__all__ = [
    "BenchmarkLocalisation",
    "LocalisationRecorder",
    "LocalisationRecording",
    "LocalisationTracker",
]
