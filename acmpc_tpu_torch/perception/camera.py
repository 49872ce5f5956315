"""Pinhole camera model and ground-plane homographies (host numpy,
float64), the port's copy of ``acmpc_tpu/perception/camera.py``: focal
length from the vertical field of view, extrinsics from a 90 + pitch
rotation about x and the camera position, world <-> image homographies
by dropping the z column. The (3, 3) ``homography_i2w`` goes to the
device as fp32 in the track extractor.
"""

from __future__ import annotations

import math

import numpy as np

from acmpc_tpu_torch.config.schema import PerceptionConfig


def _rot_x(degrees: float) -> np.ndarray:
    c, s = math.cos(math.radians(degrees)), math.sin(math.radians(degrees))
    return np.array(
        [[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], dtype=np.float64
    )


class CameraInfo:
    def __init__(
        self,
        width: int,
        height: int,
        vertical_fov_deg: float,
        position,
        pitch_deg: float,
    ):
        if not position[2] > 0.0:
            raise ValueError("the camera must be above the ground (position z > 0)")
        self.width = width
        self.height = height
        self.position = np.asarray(position, np.float64)
        self.pitch_rotation = pitch_deg
        self.vertical_fov_deg = vertical_fov_deg

        self.focal_length = height / (
            2 * math.tan(math.radians(vertical_fov_deg) / 2)
        )
        self.camera_matrix = np.array(
            [
                [self.focal_length, 0.0, width / 2],
                [0.0, self.focal_length, height / 2],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )
        self.rotation_matrix = _rot_x(90.0 + pitch_deg)
        translation = self.rotation_matrix @ (-self.position.reshape(-1, 1))
        self.extrinsic_calibration = np.hstack([self.rotation_matrix, translation])
        self.full_camera_transformation_matrix = (
            self.camera_matrix @ self.extrinsic_calibration
        )
        # ground plane (z = 0): keep columns x, y, t
        self.homography_w2i = self.full_camera_transformation_matrix[:, [0, 1, 3]]
        self.homography_i2w = np.linalg.inv(self.homography_w2i)

    @classmethod
    def from_config(cls, cfg: PerceptionConfig) -> "CameraInfo":
        return cls(
            width=cfg.image_width,
            height=cfg.image_height,
            vertical_fov_deg=cfg.vertical_fov_deg,
            position=cfg.camera_position,
            pitch_deg=cfg.camera_pitch_deg,
        )

    @staticmethod
    def _homogeneous(points: np.ndarray) -> np.ndarray:
        return np.hstack([points, np.ones((points.shape[0], 1))])

    def image_to_ground(self, image_points: np.ndarray) -> np.ndarray:
        pts = self.homography_i2w @ self._homogeneous(image_points).T
        return (pts[:2] / pts[2]).T

    def ground_to_image(self, ground_points: np.ndarray) -> np.ndarray:
        pts = self.homography_w2i @ self._homogeneous(ground_points).T
        return (pts[:2] / pts[2]).T

    def world_to_image(self, world_points: np.ndarray) -> np.ndarray:
        pts = (
            self.full_camera_transformation_matrix
            @ self._homogeneous(world_points).T
        )
        return (pts[:2] / pts[2]).T
