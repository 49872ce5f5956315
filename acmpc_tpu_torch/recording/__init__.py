from acmpc_tpu_torch.recording.recorder import DataRecorder

__all__ = ["DataRecorder"]
