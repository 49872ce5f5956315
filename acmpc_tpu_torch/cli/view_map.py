"""Map viewer and re-smoother CLI: load a map, optionally re-smooth its
boundaries, plot it to a PNG, optionally save the result.

Counterpart of ``acmpc_tpu/cli/view_map.py`` (host numpy). It always
plots, so it needs matplotlib:

    python -m acmpc_tpu_torch.cli.view_map --map data/maps/monza.npz --out monza.png
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="View / re-smooth a track map")
    parser.add_argument("--map", required=True)
    parser.add_argument("--out", default="map_view.png")
    parser.add_argument(
        "--smooth", type=int, default=0,
        help="re-smooth with this savgol window (0 = off)",
    )
    parser.add_argument("--save", default=None, help="save the re-smoothed map")
    parser.add_argument(
        "--device", default="cuda", help="torch device the map is loaded onto (default cuda)"
    )
    args = parser.parse_args(argv)

    from acmpc_tpu_torch.cli.build_map import plot_map
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.mapping.map_maker import savgol_wrap

    tm = load_track_map(args.map, device=args.device)
    built = {
        "outside_track": tm.left.cpu().numpy(),
        "inside_track": tm.right.cpu().numpy(),
        "centre_track": tm.centre.cpu().numpy(),
    }
    if args.smooth:
        for key in built:
            t = built[key]
            built[key] = np.stack(
                [savgol_wrap(t[:, 0], args.smooth), savgol_wrap(t[:, 1], args.smooth)],
                axis=1,
            )
    plot_map(built, args.out)
    if args.save:
        np.save(args.save, built, allow_pickle=True)
        print(f"saved {args.save}")
    return built


if __name__ == "__main__":
    main()
