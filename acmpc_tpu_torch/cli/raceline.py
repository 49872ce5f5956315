"""Raceline calculator CLI: compute a minimum-curvature raceline for a
track map and save (and optionally plot) it.

Counterpart of ``acmpc_tpu/cli/raceline.py``. The QPs run on the card
unless ``--device`` names another device:

    python -m acmpc_tpu_torch.cli.raceline --map data/maps/monza.npz --out monza_raceline.npy

``--plot`` needs matplotlib, imported only when asked.
"""

from __future__ import annotations

import argparse

import numpy as np

# the QP is dense in the point count, and ~600 points resolve any lap's
# raceline; a denser line comes from the mapping tools
MAX_POINTS = 600


def cap_stride(n_points: int, max_points: int = MAX_POINTS) -> int:
    """The centreline stride that keeps at most ``max_points`` points."""
    return int(np.ceil(n_points / max_points)) if n_points > max_points else 1


def corridor(centre: np.ndarray, left: np.ndarray, stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Every ``stride``-th centre point and its half width, the distance
    to the nearest left-boundary point."""
    centre = centre[::stride]
    d2 = (
        np.sum(centre**2, 1)[:, None]
        - 2 * centre @ left.T
        + np.sum(left**2, 1)[None, :]
    )
    return centre, np.sqrt(np.maximum(d2.min(axis=1), 0.0))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compute a raceline for a map")
    parser.add_argument("--map", required=True)
    parser.add_argument("--out", required=True, help="output .npy raceline")
    parser.add_argument("--margin", type=float, default=1.0)
    parser.add_argument(
        "--iterations", type=int, default=3,
        help="number of curvature re-linearisations (each solves one QP)",
    )
    parser.add_argument("--plot", default=None)
    parser.add_argument(
        "--device", default="cuda", help="torch device of the QPs (default cuda)"
    )
    args = parser.parse_args(argv)

    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.utils.raceline import calculate_raceline

    tm = load_track_map(args.map, device=args.device)
    centre_all, left = tm.centre.cpu().numpy(), tm.left.cpu().numpy()
    centre, half_width = corridor(centre_all, left, cap_stride(len(centre_all)))
    raceline = calculate_raceline(
        centre, half_width, margin=args.margin, n_iterations=args.iterations,
        device=args.device,
    )
    np.save(args.out, raceline)
    print(f"wrote raceline with {len(raceline)} points to {args.out}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 10), dpi=150)
        ax.plot(*left.T, ".", ms=1, label="left")
        ax.plot(*tm.right.cpu().numpy().T, ".", ms=1, label="right")
        ax.plot(*raceline.T, "-", lw=1.5, color="red", label="raceline")
        ax.set_aspect(1)
        ax.legend()
        fig.savefig(args.plot)
        print(f"wrote {args.plot}")
    return raceline


if __name__ == "__main__":
    main()
