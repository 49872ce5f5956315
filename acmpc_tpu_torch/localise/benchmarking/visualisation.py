"""Benchmark visualisation: a 9-panel figure of a localisation replay.

Counterpart of ``acmpc_tpu/localise/benchmarking/visualisation.py``, with
the same nine axes (particle map, BEV map, detections, step and
observation execution time, score distribution, and x / y / yaw error),
rendered to a PNG at the end of the replay. The replay drives two hooks:
``update_detections`` on every observation, ``update_particles`` on every
control step; each copies what it keeps to the host. Needs matplotlib,
imported when the visualiser is built.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class LocalisationVisualiser:
    def __init__(self, localiser, tracker):
        import matplotlib

        matplotlib.use("Agg")
        self._localiser = localiser
        self._tracker = tracker
        self._particle_snapshots = []
        self._estimates = []
        self._last_detections = None
        self._last_scores = None

    # -- replay hooks ------------------------------------------------------
    def update_particles(self):
        states = self._localiser.particle_states
        if len(self._particle_snapshots) < 50:  # bounded memory
            self._particle_snapshots.append(
                np.copy(states[:: max(1, len(states) // 100)])
            )
        self._estimates.append(np.copy(self._localiser.estimated_position))

    def update_detections(self, left: np.ndarray, right: np.ndarray):
        self._last_detections = (
            np.copy(np.asarray(left)),
            np.copy(np.asarray(right)),
        )
        self._last_scores = np.copy(self._localiser.particle_scores)

    # -- figure ------------------------------------------------------------
    def save_figure(self, path: str, gt_poses: Optional[list] = None):
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 3, figsize=(16, 14), dpi=110)
        (
            (ax_particles, ax_bev, ax_det),
            (ax_step, ax_obs, ax_dist),
            (ax_ex, ax_ey, ax_eyaw),
        ) = axes

        # -- top row: particle map / BEV map / detections ------------------
        m = self._localiser.map
        for poly, c in [
            (m.left, "#888"),
            (m.right, "#888"),
            (m.centre, "#4a4"),
        ]:
            p = poly.cpu().numpy()
            ax_particles.plot(p[:, 0], p[:, 1], ".", ms=0.5, color=c)
        if self._particle_snapshots:
            last = self._particle_snapshots[-1]
            ax_particles.plot(
                last[:, 0], last[:, 1], ".", ms=2, color="orange",
                label="particles",
            )
        if self._estimates:
            est = np.asarray(self._estimates)
            ax_particles.plot(
                est[:, 0], est[:, 1], "-", lw=1, color="red", label="estimate"
            )
        if gt_poses:
            gt = np.asarray(
                [
                    [-p[0], p[2]] if not isinstance(p, dict) else [p["x"], p["y"]]
                    for p in gt_poses
                ]
            )
            ax_particles.plot(
                gt[:, 0], gt[:, 1], "-", lw=1, color="blue", label="ground truth"
            )
        ax_particles.set_aspect(1)
        ax_particles.legend(fontsize=7)
        ax_particles.set_title("particle map")

        # BEV map: the map around the final estimate
        if self._estimates:
            ex, ey = self._estimates[-1][:2]
            for poly, c in [
                (m.left, "#888"),
                (m.right, "#888"),
                (m.centre, "#4a4"),
            ]:
                p = poly.cpu().numpy()
                near = (np.abs(p[:, 0] - ex) < 120) & (
                    np.abs(p[:, 1] - ey) < 120
                )
                ax_bev.plot(p[near, 0], p[near, 1], ".", ms=2, color=c)
            ax_bev.plot([ex], [ey], "r^", ms=10, label="estimate")
            ax_bev.set_aspect(1)
            ax_bev.legend(fontsize=7)
        ax_bev.set_title("BEV map (around estimate)")

        if self._last_detections is not None:
            left, right = self._last_detections
            if len(left):
                ax_det.plot(left[:, 0], left[:, 1], "o-", ms=3, label="left")
            if len(right):
                ax_det.plot(
                    right[:, 0], right[:, 1], "o-", ms=3, label="right"
                )
            ax_det.set_aspect(1)
            ax_det.legend(fontsize=7)
        ax_det.set_title("last detections (vehicle frame)")

        # -- middle row: execution times / score distribution --------------
        ax_step.plot(np.asarray(self._tracker.step_execution_times) * 1e3)
        ax_step.set_title("step execution time (ms)")
        ax_obs.plot(
            np.asarray(self._tracker.observation_execution_times) * 1e3
        )
        ax_obs.set_title("observation execution time (ms)")
        if self._last_scores is not None and len(self._last_scores):
            ax_dist.hist(self._last_scores, bins=40, color="#3d5a80")
        ax_dist.set_title("particle score distribution")

        # -- bottom row: x / y / yaw error ----------------------------------
        errs = self._tracker._errors
        ax_ex.plot(np.abs(np.asarray(errs["x"])))
        ax_ex.set_title("|x error| (m)")
        ax_ey.plot(np.abs(np.asarray(errs["y"])))
        ax_ey.set_title("|y error| (m)")
        ax_eyaw.plot(np.degrees(np.abs(np.asarray(errs["yaw"]))))
        ax_eyaw.set_title("|yaw error| (deg)")

        # summary strip
        s = self._tracker.summary()
        fig.suptitle(
            f"localised {s['percent_localised']:.1f}%  |  "
            f"position err {s['mean_position_error_m']:.2f} m  |  "
            f"rotation err {s['mean_rotation_error_deg']:.2f} deg  |  "
            f"{s['n_steps']} steps / {s['n_observations']} observations",
            fontsize=12,
        )
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path
