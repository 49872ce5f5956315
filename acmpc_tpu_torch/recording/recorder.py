"""Dataset capture: frames, masks, track detections and commands.

The port's copy of ``acmpc_tpu/recording/recorder.py`` (host numpy and
OpenCV, imported when first used): optional capture of images, masks and
track-limit detections plus a commands JSON per frame, until a
configured sample count is reached.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict

import numpy as np


class DataRecorder:
    def __init__(self, save_path: str, n_image_samples: int = 0):
        self.n_image_samples = n_image_samples
        self.enabled = n_image_samples > 0
        self.image_count = 0
        self._commands: Dict[int, Dict] = {}
        if self.enabled:
            base = pathlib.Path(save_path) / "datacollection"
            self._paths = {
                "images": base / "images",
                "masks": base / "masks",
                "maps": base / "maps",
                "commands": base / "commands",
            }
            for p in self._paths.values():
                p.mkdir(parents=True, exist_ok=True)

    def maybe_record_data(
        self,
        obs: Dict,
        dt: float,
        steering_angle: float,
        acceleration: float,
    ):
        if not self.enabled:
            return
        import cv2

        i = self.image_count
        for key, image in obs.items():
            if not isinstance(image, np.ndarray):
                continue
            if "RGB" in key:
                cv2.imwrite(
                    str(self._paths["images"] / f"{key}_{i}.png"),
                    cv2.cvtColor(image, cv2.COLOR_BGR2RGB),
                )
            elif "Segm" in key:
                cv2.imwrite(str(self._paths["masks"] / f"{key}_{i}.png"), image)

        self._commands[i] = {
            "dt": dt,
            "steering_angle": steering_angle,
            "acceleration": acceleration,
            "velocity": float(obs["full_pose"]["velocity"]),
        }
        if "tracks" in obs:
            np.save(
                self._paths["maps"] / f"{i}.npy",
                {
                    "centre": obs["tracks"]["centre"],
                    "left": obs["tracks"]["left"],
                    "right": obs["tracks"]["right"],
                },
                allow_pickle=True,
            )
        (self._paths["commands"] / "commands.json").write_text(
            json.dumps(self._commands)
        )
        self.image_count += 1
        if self.image_count >= self.n_image_samples - 1:
            self.enabled = False
