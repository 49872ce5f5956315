"""Localisation benchmark recordings: capture and replay.

Counterpart of ``acmpc_tpu/localise/benchmarking/recording.py``, reading
and writing the same files: two pickled dicts, ``control.npy`` of
{i: {time, control_command, game_pose}} and ``observations.npy`` of
{i: {time, tracklimits: {left, right}}}, merged and replayed sorted by
timestamp. A recording is a file this repository ships or writes, never
one from outside: unpickling runs code.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List

import numpy as np


class LocalisationRecording:
    """Time-sorted merge of a control and an observation recording."""

    def __init__(self, data_path: str):
        path = pathlib.Path(data_path)
        control = np.load(path / "control.npy", allow_pickle=True).item()
        observations = np.load(path / "observations.npy", allow_pickle=True).item()
        records: List[Dict] = list(control.values()) + list(observations.values())
        self._recording = sorted(records, key=lambda r: r["time"])

    def __getitem__(self, index: int) -> Dict:
        return self._recording[index]

    def __len__(self) -> int:
        return len(self._recording)

    def __iter__(self):
        return iter(self._recording)


class LocalisationRecorder:
    """Capture side: accumulate control and observation records during a
    run and save them in the replayable layout."""

    def __init__(self, save_dir: str):
        self._dir = pathlib.Path(save_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._control: Dict[int, Dict] = {}
        self._observations: Dict[int, Dict] = {}

    def record_control(self, t: float, control_command, game_pose):
        self._control[len(self._control)] = {
            "time": t,
            "control_command": tuple(control_command),
            "game_pose": [game_pose],
        }

    def record_observation(self, t: float, left: np.ndarray, right: np.ndarray):
        self._observations[len(self._observations)] = {
            "time": t,
            "tracklimits": {"left": np.asarray(left), "right": np.asarray(right)},
        }

    def save(self):
        np.save(self._dir / "control.npy", self._control, allow_pickle=True)
        np.save(self._dir / "observations.npy", self._observations, allow_pickle=True)
