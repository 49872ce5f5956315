"""Monte-Carlo track localisation: the particle filter.

Counterpart of ``acmpc_tpu/localise/particle_filter.py``, whose docstrings
give the design: a fixed particle count with a validity mask,
brute-force nearest-neighbour argmins (``track_map.nearest_point``), the
two-phase likelihood (a broad search sigma, then a sigma calibrated to
the population's 30th-percentile pairing error once one basin holds the
cloud), systematic resampling with adaptive shrinking jitter on ESS
collapse, mass-based convergence and the fit gate on the localised flag.

The filter is a set of functions of an explicit ``PFState`` of tensors on
the map's device. ``predict`` and ``update`` run as eager launches with
nothing read back to the host: where the JAX package branches on a
device value (``lax.cond``), the port computes both branches and picks
with ``torch.where``. The one exception is the observation-guided seeding
scan, which ships switched off: with it on, ``update`` reads ``seeded``
once an observation.

Random numbers come from one source passed to each call (``TorchDraws``,
a ``torch.Generator`` on the filter's device, or ``ScriptedDraws``, which
replays given numbers). The filter asks for them in the JAX package's
order, so a test can feed it the numbers ``jax.random`` draws for the
same key and hold the two filters to rounding, one call at a time.
Draws and the arithmetic on them are fp32.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math

import numpy as np
import torch

from acmpc_tpu_torch.localise.track_map import TrackMap, nearest_point

# the range name of update's three nearest-neighbour queries in a
# torch.profiler trace (bench/locbench.py --profile reads it)
NEAREST_POINT_RANGE = "nearest_point"


def profiled_range(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler runs, else
    nothing (a range costs ~9 us of host time even with no profiler)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class PFConfig:
    """The filter's parameters; angles in radians. See the JAX package's
    ``PFConfig`` for what each one does and why it has its value."""

    n_particles: int = 500
    n_converged_particles: int = 500
    sampling_noise_x: float = 1.1
    sampling_noise_y: float = 1.1
    sampling_noise_yaw: float = 0.0524
    control_noise_velocity: float = 0.25
    control_noise_yaw: float = 0.0349
    threshold_offset: float = 10.0
    threshold_rotation: float = 1.5708
    threshold_min_particles: int = 20
    threshold_error: float = 20.0
    score_mean: float = 0.0
    score_sigma: float = 10.0
    convergence_distance: float = 50.0
    convergence_angle: float = 1.5708
    max_observation_points: int = 256
    observation_forward_limit: float = 50.0
    adaptive_sigma: bool = True
    sigma_min: float = 0.5
    adaptive_sigma_scale: float = 1.5
    sharpen_spread_m: float = 150.0
    score_centreline: bool = False
    jitter_floor_xy: float = 0.05
    jitter_floor_yaw: float = 0.004
    ess_fraction: float = 0.5
    seed_from_observation: bool = False
    seed_max_candidates: int = 4096
    seed_sigma: float = 5.0
    seed_uniform_fraction: float = 0.2
    seed_scan_frames: int = 8
    localised_max_error: float = 0.0
    convergence_mass: float = 0.97
    sharpen_mass: float = 0.8

    @classmethod
    def from_config(cls, cfg) -> "PFConfig":
        """From the typed ``LocalisationConfig`` (degrees to radians)."""
        d = math.pi / 180.0
        return cls(
            n_particles=cfg.n_particles,
            n_converged_particles=cfg.n_converged_particles,
            sampling_noise_x=cfg.sampling_noise_xy,
            sampling_noise_y=cfg.sampling_noise_xy,
            sampling_noise_yaw=cfg.sampling_noise_yaw_deg * d,
            control_noise_velocity=cfg.control_noise_velocity,
            control_noise_yaw=cfg.control_noise_yaw_deg * d,
            threshold_offset=cfg.threshold_offset,
            threshold_rotation=cfg.threshold_rotation_deg * d,
            threshold_min_particles=cfg.threshold_minimum_particles,
            threshold_error=cfg.threshold_track_limit,
            score_mean=cfg.score_mean,
            score_sigma=cfg.score_sigma,
            convergence_distance=cfg.convergence_max_distance,
            convergence_angle=cfg.convergence_max_angle_deg * d,
            adaptive_sigma=cfg.adaptive_sigma,
            sigma_min=cfg.sigma_min,
            sharpen_spread_m=cfg.sharpen_spread_m,
            score_centreline=cfg.score_centreline,
            seed_from_observation=cfg.seed_from_observation,
            seed_max_candidates=cfg.seed_max_candidates,
            seed_sigma=cfg.seed_sigma,
            seed_uniform_fraction=cfg.seed_uniform_fraction,
            seed_scan_frames=cfg.seed_scan_frames,
            localised_max_error=cfg.localised_max_error,
            convergence_mass=cfg.convergence_mass,
            sharpen_mass=cfg.sharpen_mass,
            observation_forward_limit=cfg.observation_forward_limit,
            max_observation_points=cfg.max_observation_points,
        )


@dataclasses.dataclass(frozen=True)
class PFState:
    """The filter's state, tensors on the map's device. The JAX state also
    carries its PRNG key; here the draws are the caller's (``TorchDraws``)."""

    states: torch.Tensor  # (N, 3) fp32: x, y, yaw
    scores: torch.Tensor  # (N,) fp32 posterior weights
    valid: torch.Tensor  # (N,) bool
    converged: torch.Tensor  # () bool
    previously_converged: torch.Tensor  # () bool
    seeded: torch.Tensor  # () bool: an observation-guided seed happened
    fit_error: torch.Tensor  # () fp32: last 30th-percentile valid pairing error (m)
    cand_logw: torch.Tensor  # (C,) fp32 seeding-scan log-likelihoods
    seed_obs_count: torch.Tensor  # () int32 observations scanned
    cand_shift_m: torch.Tensor  # () fp32 metres driven since the reset

    def replace(self, **changes) -> "PFState":
        return dataclasses.replace(self, **changes)


def _where_state(cond: torch.Tensor, a: PFState, b: PFState) -> PFState:
    """Field by field, ``a`` where ``cond`` (a 0-d bool) else ``b``."""
    return PFState(
        **{
            f.name: torch.where(cond, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(PFState)
        }
    )


class TorchDraws:
    """fp32 normal and uniform draws from a ``torch.Generator`` on
    ``device``, seeded with ``seed``."""

    def __init__(self, seed: int, device: torch.device | str):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def uniform(self, shape: tuple = ()) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)


class ScriptedDraws:
    """Draws given in advance as ``(kind, array)`` pairs, ``kind`` "normal"
    or "uniform", handed out in order. A request of another kind or shape
    than the next pair's raises."""

    def __init__(self, draws, device: torch.device | str):
        self.device = torch.device(device)
        self._draws = collections.deque(draws)

    def extend(self, draws) -> None:
        self._draws.extend(draws)

    def __len__(self) -> int:
        return len(self._draws)

    def _next(self, kind: str, shape: tuple) -> torch.Tensor:
        if not self._draws:
            raise IndexError(f"no scripted draw left for {kind}{tuple(shape)}")
        got_kind, value = self._draws.popleft()
        value = np.array(value, np.float32)  # a writable copy
        if got_kind != kind or value.shape != tuple(shape):
            raise ValueError(
                f"scripted draw is {got_kind}{value.shape}, the filter asked for {kind}{tuple(shape)}"
            )
        return torch.as_tensor(value, device=self.device)

    def normal(self, shape: tuple) -> torch.Tensor:
        return self._next("normal", shape)

    def uniform(self, shape: tuple = ()) -> torch.Tensor:
        return self._next("uniform", shape)


def _wrap_pi(angle: torch.Tensor) -> torch.Tensor:
    """``angle`` wrapped to [-pi, pi): a floor modulo, as ``jnp.mod``."""
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 2."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _to_world(poses: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """BEV points ``obs`` (Q, 2) seen from each pose (K, 3), in the world
    frame (K, Q, 2): rotated by the transpose of R(pi/2 - yaw), then
    translated."""
    angle = -poses[:, 2] + math.pi / 2
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    ox, oy = obs[None, :, 0], obs[None, :, 1]
    wx = cos * ox + sin * oy + poses[:, 0:1]
    wy = -sin * ox + cos * oy + poses[:, 1:2]
    return torch.stack([wx, wy], dim=-1)


def reset_indices(n_map: int, n_particles: int) -> np.ndarray:
    """Centreline indices of the blind reset: ``jnp.linspace(0, n_map - 3,
    n_particles)`` in fp32, truncated, with the JAX formula's rounding."""
    stop = np.float32(n_map - 3)
    if n_particles == 1:
        return np.zeros(1, np.int32)
    div = n_particles - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.concatenate([stop * step, [stop]]).astype(np.float32)
    return out.astype(np.int32)


class ParticleFilter:
    """The filter bound to one (config, map) pair, on the map's device."""

    def __init__(self, config: PFConfig, track_map: TrackMap, wheelbase: float = 2.65):
        self.config = config
        self.map = track_map
        self.device = track_map.centre.device
        self._wheelbase = wheelbase
        self._seed_cache = None
        n = config.n_particles
        dev = self.device
        self._seq = torch.arange(config.max_observation_points, device=dev)
        self._slot = torch.arange(n, device=dev)
        self._arange_n = torch.arange(n, dtype=torch.float32, device=dev)
        self._jitter_floor = torch.tensor(
            [config.jitter_floor_xy, config.jitter_floor_xy, config.jitter_floor_yaw], device=dev
        )
        self._jitter_cap = torch.tensor(
            [config.sampling_noise_x, config.sampling_noise_y, config.sampling_noise_yaw], device=dev
        )
        self._kappa = torch.tensor([0.1, 0.1, 0.01], device=dev)
        self._average_spacing = track_map.average_spacing
        idx = torch.as_tensor(reset_indices(track_map.n_centre, n), device=dev).long()
        p0, p1 = track_map.centre[idx], track_map.centre[idx + 1]
        yaw = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
        self._reset_states = torch.cat([p0, yaw[:, None]], dim=1)
        self._reset = self._blind_state()

    # ------------------------------------------------------------------
    def _seed_tables(self):
        """The seeding scan's tables (a pose and the nearest left and right
        boundary index per centreline index, and the candidate stride),
        made once on the host with scipy's cKDTree."""
        if self._seed_cache is None:
            from scipy.spatial import cKDTree

            centre = self.map.centre.detach().cpu().numpy().astype(np.float64)
            m = len(centre)
            stride = max(1, int(np.ceil(m / self.config.seed_max_candidates)))
            p1 = np.roll(centre, -1, axis=0)
            yaw = np.arctan2(p1[:, 1] - centre[:, 1], p1[:, 0] - centre[:, 0])
            poses = np.concatenate([centre, yaw[:, None]], axis=1).astype(np.float32)
            left_idx = cKDTree(self.map.left.detach().cpu().numpy().astype(np.float64)).query(centre)[1]
            right_idx = cKDTree(self.map.right.detach().cpu().numpy().astype(np.float64)).query(centre)[1]
            dev = self.device
            self._seed_cache = (
                torch.as_tensor(poses, device=dev),
                torch.as_tensor(left_idx, device=dev).long(),
                torch.as_tensor(right_idx, device=dev).long(),
                stride,
                torch.tensor(
                    [self.config.sampling_noise_x, self.config.sampling_noise_y, self.config.sampling_noise_yaw],
                    device=dev,
                ),
            )
        return self._seed_cache

    @property
    def n_candidates(self) -> int:
        m = self.map.n_centre
        stride = max(1, -(-m // self.config.seed_max_candidates))
        return -(-m // stride)

    # ------------------------------------------------------------------
    def _blind_state(self) -> PFState:
        n, dev = self.config.n_particles, self.device
        false = torch.zeros((), dtype=torch.bool, device=dev)
        return PFState(
            states=self._reset_states,
            scores=torch.full((n,), 1.0 / n, device=dev),
            valid=torch.ones((n,), dtype=torch.bool, device=dev),
            converged=false,
            previously_converged=false,
            seeded=false,
            fit_error=torch.full((), math.inf, device=dev),
            cand_logw=torch.zeros((self.n_candidates,), device=dev),
            seed_obs_count=torch.zeros((), dtype=torch.int32, device=dev),
            cand_shift_m=torch.zeros((), device=dev),
        )

    def reset(self) -> PFState:
        """Particles along the whole centreline (draws nothing)."""
        return self._reset

    # ------------------------------------------------------------------
    def _candidate_indices(self, cand_shift_m: torch.Tensor) -> torch.Tensor:
        """Each scan candidate's centreline index, advanced by the distance
        driven since the reset."""
        _, _, _, stride, _ = self._seed_tables()
        shift = torch.round(cand_shift_m / torch.clamp(self._average_spacing, min=1e-6)).to(torch.int64)
        idx = torch.arange(self.n_candidates, device=self.device) * stride + shift
        return torch.remainder(idx, self.map.n_centre)

    def _cand_frame_logscore(
        self, cand_shift_m, obs_left, obs_left_mask, obs_right, obs_right_mask, left_start, right_start
    ) -> torch.Tensor:
        """One scan frame: the observation's log-likelihood under every
        candidate pose."""
        poses, left_align, right_align, _, _ = self._seed_tables()
        idx = self._candidate_indices(cand_shift_m)
        p = obs_left.shape[0]
        obs = torch.cat([obs_left, obs_right], dim=0)
        obs_mask = torch.cat([obs_left_mask, obs_right_mask], dim=0)
        obs_world = _to_world(poses[idx], obs)  # (C, 2P, 2)
        seq = self._seq[:p]
        ml, mr = self.map.left.shape[0], self.map.right.shape[0]
        left_slice = self.map.left[torch.remainder(left_align[idx][:, None] + left_start + seq, ml)]
        right_slice = self.map.right[torch.remainder(right_align[idx][:, None] + right_start + seq, mr)]
        err = _norm2(obs_world - torch.cat([left_slice, right_slice], dim=1))
        denom = torch.clamp(torch.sum(obs_mask), min=1)
        mean_err = torch.sum(err * obs_mask, dim=1) / denom
        return -0.5 * (mean_err / self.config.seed_sigma) ** 2

    def _draw_from_candidates(self, state: PFState, draws, logw: torch.Tensor) -> PFState:
        """The seed population drawn from the accumulated scan weights at
        the candidates' current poses, with a uniform floor."""
        cfg = self.config
        poses, _, _, _, jit_sigma = self._seed_tables()
        cand_states = poses[self._candidate_indices(state.cand_shift_m)]
        c, n, dev = self.n_candidates, cfg.n_particles, self.device
        w = torch.exp(logw - torch.max(logw))
        wsum = torch.sum(w)
        w = torch.where(wsum > 1e-20, w / torch.clamp(wsum, min=1e-30), 1.0 / c)
        n_uniform = int(round(n * cfg.seed_uniform_fraction))
        n_guided = n - n_uniform
        cum = torch.cumsum(w, dim=0)
        u = (torch.arange(n_guided, dtype=torch.float32, device=dev) + draws.uniform(())) / n_guided
        draw = torch.clamp(torch.searchsorted(cum, u, right=True), 0, c - 1)
        step = max(1, c // max(n_uniform, 1))
        uniform = cand_states[(torch.arange(n_uniform, device=dev) * step) % c]
        states = torch.cat([cand_states[draw], uniform], dim=0)
        states = states + draws.normal((n, 3)) * jit_sigma
        return self._reset.replace(
            states=states,
            previously_converged=state.previously_converged,
            seeded=torch.ones((), dtype=torch.bool, device=dev),
        )

    def _scan_step(self, state: PFState, draws, obs_left, obs_left_mask, obs_right, obs_right_mask,
                   left_start, right_start) -> PFState:
        """Fold this observation into the candidate log-likelihoods; on the
        last scan frame, replace the population with the scan's draw."""
        logw = state.cand_logw + self._cand_frame_logscore(
            state.cand_shift_m, obs_left, obs_left_mask, obs_right, obs_right_mask, left_start, right_start
        )
        logw = logw - torch.max(logw)
        cnt = state.seed_obs_count + 1
        drawn = self._draw_from_candidates(state, draws, logw)
        return _where_state(
            cnt >= self.config.seed_scan_frames, drawn, state.replace(cand_logw=logw, seed_obs_count=cnt)
        )

    # ------------------------------------------------------------------
    def predict(self, state: PFState, tyre_angle: float, velocity: float, dt: float, draws) -> PFState:
        """Kinematic back-axle bicycle motion with per-particle control
        noise: two normal (N,) draws, yaw noise then speed noise. The
        inputs are rounded to fp32, as the JAX package takes them."""
        cfg = self.config
        n = cfg.n_particles
        tyre_angle, velocity, dt = (float(np.float32(v)) for v in (tyre_angle, velocity, dt))
        delta = tyre_angle + cfg.control_noise_yaw * draws.normal((n,))
        vel = torch.abs(velocity + cfg.control_noise_velocity * draws.normal((n,)))
        phi = state.states[:, 2]
        x_dot = torch.stack(
            [vel * torch.cos(phi), vel * torch.sin(phi), vel * torch.tan(delta) / self._wheelbase], dim=1
        )
        return state.replace(
            states=state.states + x_dot * dt,
            cand_shift_m=state.cand_shift_m + float(np.float32(abs(velocity)) * np.float32(dt)),
        )

    # ------------------------------------------------------------------
    def update(
        self,
        state: PFState,
        obs_left: torch.Tensor,  # (P, 2) padded BEV left track limit
        obs_left_mask: torch.Tensor,  # (P,) bool
        obs_right: torch.Tensor,  # (P, 2)
        obs_right_mask: torch.Tensor,
        draws,
        left_start: int | torch.Tensor = 0,  # slice-start offsets (map indices)
        right_start: int | torch.Tensor = 0,
        obs_centre: torch.Tensor | None = None,  # (P, 2) optional third curve
        obs_centre_mask: torch.Tensor | None = None,
        centre_start: int | torch.Tensor = 0,
    ) -> PFState:
        """Score the particles against a track-limit observation, threshold
        them, then resample, or reset when fewer than
        ``threshold_min_particles`` survive. Draws one uniform and one
        normal (N, 3) for the resample whichever way it goes (and, while
        the seeding scan runs, the same two before them)."""
        cfg = self.config
        limit = cfg.observation_forward_limit
        obs_left_mask = obs_left_mask & (obs_left[:, 1] < limit)
        obs_right_mask = obs_right_mask & (obs_right[:, 1] < limit)

        # the seeding scan ships off; with it on, this is update's one read
        # of the device (once an observation)
        if cfg.seed_from_observation and not bool(state.seeded):
            state = self._scan_step(
                state, draws, obs_left, obs_left_mask, obs_right, obs_right_mask, left_start, right_start
            )
        states = state.states
        locs = states[:, :2]
        with profiled_range(NEAREST_POINT_RANGE):
            centre_off, centre_idx = nearest_point(locs, self.map.centre)
            _, left_idx = nearest_point(locs, self.map.left)
            _, right_idx = nearest_point(locs, self.map.right)

        # heading offset against the local track direction
        mc = self.map.centre.shape[0]
        p0 = self.map.centre[torch.remainder(centre_idx, mc - 1)]
        p1 = self.map.centre[torch.remainder(centre_idx + 1, mc - 1)]
        track_heading = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])
        heading_offset = torch.abs(_wrap_pi(track_heading - states[:, 2]))

        use_centre = obs_centre is not None
        if use_centre:
            obs_centre_mask = obs_centre_mask & (obs_centre[:, 1] < limit)
            obs = torch.cat([obs_left, obs_right, obs_centre], dim=0)
            obs_mask = torch.cat([obs_left_mask, obs_right_mask, obs_centre_mask], dim=0)
        else:
            obs = torch.cat([obs_left, obs_right], dim=0)
            obs_mask = torch.cat([obs_left_mask, obs_right_mask], dim=0)
        obs_world = _to_world(states, obs)  # (N, 2P or 3P, 2)

        # wrap-indexed map slices matched point for point
        p = obs_left.shape[0]
        seq = self._seq[:p]
        ml, mr = self.map.left.shape[0], self.map.right.shape[0]
        slices = [
            self.map.left[torch.remainder(left_idx[:, None] + left_start + seq, ml)],
            self.map.right[torch.remainder(right_idx[:, None] + right_start + seq, mr)],
        ]
        if use_centre:
            slices.append(self.map.centre[torch.remainder(centre_idx[:, None] + centre_start + seq, mc)])
        err = _norm2(obs_world - torch.cat(slices, dim=1))
        denom = torch.clamp(torch.sum(obs_mask), min=1)
        mean_err = torch.sum(err * obs_mask, dim=1) / denom

        valid = (
            (heading_offset < cfg.threshold_rotation)
            & (centre_off < cfg.threshold_offset)
            & (mean_err < cfg.threshold_error)
            & state.valid
        )
        n_valid = torch.sum(valid)

        # likelihood calibration, gated on convergence or one basin (the
        # JAX package's update() explains the two phases)
        err_valid = torch.where(valid, mean_err, math.inf)
        e_min = torch.min(err_valid)
        e_min = torch.where(torch.isfinite(e_min), e_min, cfg.score_sigma)
        err_sorted = torch.sort(err_valid).values
        q_idx = torch.clamp((0.3 * n_valid).to(torch.int64), 0, cfg.n_particles - 1)
        e_q_raw = torch.index_select(err_sorted, 0, q_idx.reshape(1))[0]
        state = state.replace(fit_error=e_q_raw)
        if cfg.adaptive_sigma:
            e_q = torch.where(torch.isfinite(e_q_raw), e_q_raw, cfg.score_sigma)
            sigma_sharp = torch.clamp(cfg.adaptive_sigma_scale * e_q, cfg.sigma_min, cfg.score_sigma)
            denom_v = torch.clamp(n_valid, min=1)
            mu_v = torch.sum(torch.where(valid[:, None], locs, 0.0), dim=0) / denom_v
            spread_v = torch.max(torch.where(valid, _norm2(locs - mu_v), 0.0))
            one_basin = spread_v < cfg.sharpen_spread_m
            if cfg.convergence_mass > 0:
                w_in = torch.where(valid, state.scores, 0.0)
                w_in = w_in / torch.clamp(torch.sum(w_in), min=1e-30)
                mu_w = torch.sum(w_in[:, None] * locs, dim=0)
                mass_near = torch.sum(torch.where(_norm2(locs - mu_w) < cfg.sharpen_spread_m, w_in, 0.0))
                one_basin = one_basin | (mass_near >= cfg.sharpen_mass)
            sigma_eff = torch.where(state.converged | one_basin, sigma_sharp, cfg.score_sigma)
        else:
            sigma_eff = cfg.score_sigma
        z = (mean_err - cfg.score_mean) / sigma_eff
        score = torch.exp(-0.5 * z * z)

        # posterior weights accumulated in log space with a max shift
        logw = torch.log(torch.clamp(state.scores, min=1e-30)) + torch.log(torch.clamp(score, min=1e-30))
        logw = torch.where(valid, logw, -math.inf)
        logw = logw - torch.max(torch.where(valid, logw, -1e30))
        post = torch.where(valid, torch.exp(logw), 0.0)
        psum = torch.sum(post)
        post = torch.where(
            psum > 0, post / torch.clamp(psum, min=1e-30), valid / torch.clamp(n_valid, min=1)
        )
        state = state.replace(scores=post, valid=valid)

        # population collapse resets to the blind prior, else resample:
        # both are computed, the flag picks one on the device
        collapsed = self._reset.replace(previously_converged=state.previously_converged)
        resampled = self._resample(state, draws, n_valid, e_min)
        state = _where_state(n_valid < cfg.threshold_min_particles, collapsed, resampled)
        return self._update_convergence(state)

    # ------------------------------------------------------------------
    def _resample(self, state: PFState, draws, n_valid: torch.Tensor, e_min: torch.Tensor) -> PFState:
        """Systematic resampling with adaptive shrinking jitter on ESS
        collapse, plus the dead-slot refill: survivors compacted to the
        front (a stable sort), replacements drawn by cumulative weight.
        Draws one uniform, then one normal (N, 3)."""
        cfg = self.config
        n = cfg.n_particles
        order = torch.argsort((~state.valid).to(torch.int32), stable=True)
        states_c = state.states[order]
        scores_c = state.scores[order]
        valid_c = state.valid[order]

        weights = torch.where(valid_c, scores_c, 0.0)
        wsum = torch.sum(weights)
        uniform = valid_c / torch.clamp(n_valid, min=1)
        weights = torch.where(wsum > 0, weights / torch.clamp(wsum, min=1e-30), uniform)

        cum = torch.cumsum(weights, dim=0)
        u = (self._arange_n + draws.uniform(())) / n
        draw = torch.clamp(torch.searchsorted(cum, u, right=True), 0, n - 1)

        # adaptive jitter from the weighted cloud (circular in yaw)
        mu_xy = torch.sum(weights[:, None] * states_c[:, :2], dim=0)
        var_xy = torch.sum(weights[:, None] * (states_c[:, :2] - mu_xy) ** 2, dim=0)
        cyaw = torch.sum(weights * torch.cos(states_c[:, 2]))
        syaw = torch.sum(weights * torch.sin(states_c[:, 2]))
        mu_yaw = torch.atan2(syaw, cyaw)
        dev = _wrap_pi(states_c[:, 2] - mu_yaw)
        var_yaw = torch.sum(weights * dev**2)
        std = torch.sqrt(torch.cat([var_xy, var_yaw[None]]) + 1e-12)
        jit_sigma = torch.clamp(0.5 * std + self._kappa * e_min, self._jitter_floor, self._jitter_cap)
        noise = draws.normal((n, 3)) * jit_sigma

        ess = 1.0 / torch.clamp(torch.sum(weights**2), min=1e-30)
        resample_all = ess < cfg.ess_fraction * n_valid
        is_survivor = (self._slot < n_valid) & ~resample_all
        new_states = torch.where(is_survivor[:, None], states_c, states_c[draw] + noise)
        new_scores = torch.where(is_survivor, scores_c, 1.0 / n)
        desired = torch.where(state.converged, cfg.n_converged_particles, cfg.n_particles)
        new_valid = self._slot < torch.maximum(desired, n_valid)
        return state.replace(states=new_states, scores=new_scores, valid=new_valid)

    # ------------------------------------------------------------------
    def estimate(self, state: PFState) -> torch.Tensor:
        """Score-weighted mean pose (3,), yaw averaged on the circle; the
        plain mean of the valid particles when the weights vanish."""

        def wmean(w):
            wsum = torch.clamp(torch.sum(w), min=1e-30)
            xy = torch.sum(state.states[:, :2] * w[:, None], dim=0) / wsum
            c = torch.sum(w * torch.cos(state.states[:, 2])) / wsum
            s = torch.sum(w * torch.sin(state.states[:, 2])) / wsum
            return torch.cat([xy, torch.atan2(s, c)[None]])

        w = torch.where(state.valid, state.scores, 0.0)
        est = wmean(w)
        fallback = wmean(state.valid.to(state.scores.dtype))
        return torch.where((torch.sum(w) > 0) & torch.all(torch.isfinite(est)), est, fallback)

    def _update_convergence(self, state: PFState) -> PFState:
        """Converged when the convergence mass of the posterior lies within
        the distance and angle of the estimate (or, with
        ``convergence_mass`` 0, every valid particle does), and the fit
        error is under ``localised_max_error`` when that is set."""
        cfg = self.config
        est = self.estimate(state)
        d = torch.where(state.valid, _norm2(state.states[:, :2] - est[:2]), -math.inf)
        dyaw = _wrap_pi(state.states[:, 2] - est[2])
        a = torch.where(state.valid, torch.abs(dyaw), -math.inf)
        if cfg.convergence_mass > 0:
            w = torch.where(state.valid, state.scores, 0.0)
            w = w / torch.clamp(torch.sum(w), min=1e-30)
            near = torch.sum(torch.where(d < cfg.convergence_distance, w, 0.0))
            aligned = torch.sum(torch.where(torch.abs(a) < cfg.convergence_angle, w, 0.0))
            converged = (near >= cfg.convergence_mass) & (aligned >= cfg.convergence_mass)
        else:
            converged = (torch.max(d) < cfg.convergence_distance) & (torch.max(a) < cfg.convergence_angle)
        if cfg.localised_max_error > 0:
            converged = converged & (state.fit_error < cfg.localised_max_error)
        return state.replace(converged=converged, previously_converged=state.previously_converged | converged)
