"""Host-side localiser facade.

Counterpart of ``acmpc_tpu/localise/localiser.py``: ``step()`` advances
the particles from the control input at wall-clock dt, a track-limit
observation triggers scoring, and the agent reads ``is_localised``,
``estimated_position`` and ``estimated_map_index``. The filter state
lives on the map's device (CUDA unless the caller names another); the
observation is prepared on the host (orientation, resampling at the map
spacing, padding) and goes to the card in one pinned, asynchronous copy,
so neither ``step`` nor ``observe_tracklimits`` waits for the card. Only
the three readers above read it back.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from acmpc_tpu_torch.config.schema import LocalisationConfig
from acmpc_tpu_torch.device import resolve_device
from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
from acmpc_tpu_torch.localise.particle_filter import PFConfig, ParticleFilter, TorchDraws
from acmpc_tpu_torch.localise.track_map import TrackMap, load_track_map, nearest_point


class Localiser:
    def __init__(
        self,
        cfg: LocalisationConfig,
        track_map: TrackMap | str,
        vehicle: VehicleParams | None = None,
        seed: int = 0,
        device: torch.device | str | None = None,
        draws=None,
    ):
        """``draws`` replaces the seeded ``TorchDraws`` (tests pass
        ``ScriptedDraws``); ``reset(seed)`` goes back to a seeded one."""
        self.device = resolve_device(device)
        if isinstance(track_map, str):
            track_map = load_track_map(track_map, device=self.device)
        else:
            track_map = TrackMap(*(t.to(self.device) for t in (track_map.centre, track_map.left, track_map.right)))
        self._vehicle = vehicle or VehicleParams()
        self._pf_config = PFConfig.from_config(cfg)
        if self._pf_config.score_centreline:
            warnings.warn(
                "localisation.score_distribution.centreline is enabled: "
                "measured to DEGRADE real-perception accuracy up to ~8x "
                "(see docs/LOCALISATION.md, 'Third-curve scoring'); it is "
                "shipped default-off for a reason.",
                stacklevel=2,
            )
        self._pf = ParticleFilter(self._pf_config, track_map, wheelbase=self._vehicle.wheelbase)
        self._state = self._pf.reset()
        self._draws = draws if draws is not None else TorchDraws(seed, self.device)
        self._previous_timestamp = time.monotonic()
        self._avg_spacing = float(track_map.average_spacing)

    # -- agent-facing API ------------------------------------------------
    @property
    def map(self) -> TrackMap:
        return self._pf.map

    @property
    def is_localised(self) -> bool:
        return bool(self._state.converged)

    @property
    def estimated_position(self) -> np.ndarray:
        return self._pf.estimate(self._state).cpu().numpy()

    @property
    def estimated_map_index(self) -> int:
        pos = torch.as_tensor(self.estimated_position[:2], device=self.device)
        return int(nearest_point(pos[None, :], self._pf.map.centre)[1][0])

    def reset(self, seed: int = 0):
        self._state = self._pf.reset()
        self._draws = TorchDraws(seed, self.device)

    def step(self, control_input, dt: float | None = None):
        """Advance the particles from (steering, acceleration, velocity):
        the normalised steering becomes a road-wheel angle, negated to the
        map frame convention."""
        if dt is None:
            now = time.monotonic()
            dt = now - self._previous_timestamp
            self._previous_timestamp = now
        tyre_angle = -self._vehicle.steering_angle(float(control_input[0]))
        velocity = float(control_input[2])
        self._state = self._pf.predict(self._state, tyre_angle, velocity, dt, self._draws)

    def observe_tracklimits(self, left: np.ndarray, right: np.ndarray):
        """Score the particles against a BEV track-limit observation. With
        ``score_centreline`` on, a third curve is the midpoint of the
        boundary pairs aligned in map-index space, scored against the map
        centreline."""
        ln, sl = self._normalise(left)
        rn, sr = self._normalise(right)
        curves = [self._pad(ln), self._pad(rn)]
        centre_start = 0
        if self._pf_config.score_centreline:
            k0 = max(sl, sr)
            n = min(len(ln) - (k0 - sl), len(rn) - (k0 - sr))
            if n >= 2:
                cen = 0.5 * (ln[k0 - sl : k0 - sl + n] + rn[k0 - sr : k0 - sr + n])
                centre_start = k0
            else:  # no aligned overlap this frame: an empty third curve
                cen = np.zeros((0, 2), np.float32)
            curves.append(self._pad(cen))
        points, masks = self._upload(curves)
        centre = {}
        if len(points) == 3:
            centre = dict(obs_centre=points[2], obs_centre_mask=masks[2], centre_start=centre_start)
        self._state = self._pf.update(
            self._state, points[0], masks[0], points[1], masks[1], self._draws, sl, sr, **centre
        )

    # -- helpers ---------------------------------------------------------
    def _prepare(self, obs: np.ndarray):
        """One boundary normalised, padded and on the device: (points (P,
        2), mask (P,), visible-start offset in map indices). See the JAX
        package's ``_prepare`` for why the map slice starts there."""
        obs, start = self._normalise(obs)
        points, masks = self._upload([self._pad(obs)])
        return points[0], masks[0], start

    def _normalise(self, obs: np.ndarray) -> tuple[np.ndarray, int]:
        """Orient near-to-far, resample along the arclength at the map's
        spacing on a real density mismatch, and measure the visible-start
        offset (the forward coordinate of the first point, in map
        indices)."""
        obs = np.asarray(obs, np.float32)[:, :2]
        p = self._pf_config.max_observation_points
        if len(obs) > 1:
            # compare the mean forward coordinate of the first and last few
            # points: one endpoint mis-flips a hairpin
            k = max(1, min(5, len(obs) // 4))
            if obs[:k, 1].mean() > obs[-k:, 1].mean():  # far-to-near: flip
                obs = obs[::-1]
            seg = np.linalg.norm(obs[1:] - obs[:-1], axis=1)
            ratio = seg.mean() / self._avg_spacing
            if ratio > 1.5 or ratio < 0.67:
                s = np.concatenate([[0.0], np.cumsum(seg)])
                n = int(s[-1] / self._avg_spacing) + 1
                n = max(2, min(n, p))
                si = np.arange(n, dtype=np.float32) * self._avg_spacing
                obs = np.stack(
                    [np.interp(si, s, obs[:, 0]), np.interp(si, s, obs[:, 1])], axis=1
                ).astype(np.float32)
        obs = obs[:p]
        start = int(round(max(float(obs[0, 1]), 0.0) / self._avg_spacing)) if len(obs) else 0
        return obs, start

    def _pad(self, obs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The first ``max_observation_points`` points, zero-padded to that
        size, and their mask (host arrays)."""
        p = self._pf_config.max_observation_points
        obs = np.asarray(obs, np.float32)[:p]
        padded = np.zeros((p, 2), np.float32)
        mask = np.zeros((p,), bool)
        padded[: len(obs)] = obs
        mask[: len(obs)] = True
        return padded, mask

    def _upload(self, curves):
        """Padded (points, mask) pairs to the device in one copy, from
        pinned memory and asynchronous on the card."""
        host = np.concatenate(
            [np.concatenate([pts, m[:, None].astype(np.float32)], axis=1) for pts, m in curves], axis=1
        )
        buf = torch.from_numpy(host)
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        points = [buf[:, 3 * i : 3 * i + 2] for i in range(len(curves))]
        masks = [buf[:, 3 * i + 2] > 0.5 for i in range(len(curves))]
        return points, masks

    # exposed for benchmarking and diagnostics
    @property
    def particle_states(self) -> np.ndarray:
        return self._state.states[self._state.valid].cpu().numpy()

    @property
    def particle_scores(self) -> np.ndarray:
        return self._state.scores[self._state.valid].cpu().numpy()
