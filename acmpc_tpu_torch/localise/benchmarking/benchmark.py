"""Offline localisation benchmark: replay a recording through the filter.

Counterpart of ``acmpc_tpu/localise/benchmarking/benchmark.py``: the
replay drives the production ``Localiser`` directly, with the recorded
timestamps as dt, and the tracker scores it. On the card each
observation is also bracketed by two CUDA events outside the tracker's
host timer, so ``observation_device_ms()`` gives the synchronised time of
every update: the tracker's read of ``is_localised`` empties the queue
after each one, so the first event runs as soon as it is recorded and the
second when the update's last kernel ends.
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, Optional

import torch

from acmpc_tpu_torch.config.schema import LocalisationConfig
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.localise.benchmarking.recording import LocalisationRecording
from acmpc_tpu_torch.localise.benchmarking.tracker import LocalisationTracker
from acmpc_tpu_torch.localise.localiser import Localiser
from acmpc_tpu_torch.localise.particle_filter import profiled_range

# the torch.profiler range of each replayed call (bench/locbench.py --profile)
STEP_RANGE, OBSERVE_RANGE = "localiser.step", "localiser.observe"


class BenchmarkLocalisation:
    def __init__(
        self,
        data_path: str,
        map_path: str,
        localisation_cfg: LocalisationConfig,
        vehicle: Optional[VehicleParams] = None,
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self._recording = LocalisationRecording(data_path)
        self.localiser = Localiser(localisation_cfg, map_path, vehicle=vehicle, seed=seed, device=device)
        gt = [r["game_pose"][0] for r in self._recording if "game_pose" in r]
        self.tracker = LocalisationTracker(self.localiser, gt)
        self._last_timestamp: Optional[float] = None
        self._events: list = []

    def run(self, visualiser=None, max_steps: Optional[int] = None) -> Dict:
        """Replay the recording (its first ``max_steps`` control steps when
        given) and return the tracker's summary. An optional
        ``LocalisationVisualiser`` gets ``update_particles`` after every
        control step and ``update_detections`` after every observation,
        outside the timed calls."""
        on_card = self.localiser.device.type == "cuda"
        n_steps = 0
        for record in self._recording:
            if "control_command" in record:
                if max_steps is not None and n_steps >= max_steps:
                    break
                n_steps += 1
                dt = self._dt(record["time"])
                with profiled_range(STEP_RANGE):
                    t0 = perf_counter()
                    self.localiser.step(record["control_command"], dt=dt)
                    elapsed = perf_counter() - t0
                self.tracker.update_step(elapsed)
                if visualiser is not None:
                    visualiser.update_particles()
            elif "tracklimits" in record:
                obs = record["tracklimits"]
                with profiled_range(OBSERVE_RANGE):
                    if on_card:
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                    t0 = perf_counter()
                    self.localiser.observe_tracklimits(obs["left"], obs["right"])
                    elapsed = perf_counter() - t0
                    if on_card:
                        end.record()
                        self._events.append((start, end))
                self.tracker.update_observation(elapsed)
                if visualiser is not None:
                    visualiser.update_detections(obs["left"], obs["right"])
        return self.tracker.summary()

    def observation_device_ms(self) -> list[float]:
        """The card's time of each observation so far, from its CUDA events
        (empty off the card)."""
        if self._events:
            self._events[-1][1].synchronize()
        return [start.elapsed_time(end) for start, end in self._events]

    def _dt(self, timestamp: float) -> float:
        if self._last_timestamp is None:
            self._last_timestamp = timestamp
            return 0.0
        dt = timestamp - self._last_timestamp
        self._last_timestamp = timestamp
        return dt
