"""Map build/rebuild CLI (host numpy and the C++ tour).

Counterpart of ``acmpc_tpu/cli/build_map.py``: rebuild a map from the raw
boundary points a mapping run saved beside its map:

    python -m acmpc_tpu_torch.cli.build_map --raw <name>-raw-points.npy --out <map>.npy

``--plot`` needs matplotlib, imported only when asked.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build a track map from raw points")
    parser.add_argument(
        "--raw", required=True, help="<name>-raw-points.npy from a mapping run"
    )
    parser.add_argument("--out", required=True, help="output map path (.npy)")
    parser.add_argument(
        "--plot", default=None, help="optionally save a PNG visualisation"
    )
    args = parser.parse_args(argv)

    from acmpc_tpu_torch.mapping import MapMaker

    raw = np.load(args.raw, allow_pickle=True).item()
    maker = MapMaker()
    built = maker.build_map(np.asarray(raw["insides"]), np.asarray(raw["outsides"]))
    np.save(args.out, built, allow_pickle=True)
    print(
        f"built map: centre={len(built['centre_track'])} pts, "
        f"inside={len(built['inside_track'])}, outside={len(built['outside_track'])}"
    )
    if args.plot:
        plot_map(built, args.plot)
    return built


def plot_map(built: dict, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10), dpi=150)
    for key, colour in [
        ("outside_track", "tab:blue"),
        ("inside_track", "tab:orange"),
        ("centre_track", "tab:green"),
    ]:
        pts = built[key]
        ax.plot(pts[:, 0], pts[:, 1], ".", ms=1, color=colour, label=key)
    ax.set_aspect(1)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
