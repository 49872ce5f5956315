from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.perception.observations import ObservationDict
from acmpc_tpu_torch.perception.perceiver import Perceiver
from acmpc_tpu_torch.perception.segmentation import TrackSegmenter
from acmpc_tpu_torch.perception.tracks import TrackLimitExtractor

__all__ = [
    "CameraInfo",
    "ObservationDict",
    "Perceiver",
    "TrackLimitExtractor",
    "TrackSegmenter",
]
