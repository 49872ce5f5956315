"""Offline localisation benchmark CLI: replay a recorded control and
observation stream through the particle filter and print % localised,
mean position error and mean rotation error.

Counterpart of ``acmpc_tpu/cli/benchmark_localisation.py``. The filter
runs on the card unless ``--device`` names another device:

    python -m acmpc_tpu_torch.cli.benchmark_localisation --benchmark-config configs/benchmarks/monza.yaml
    python -m acmpc_tpu_torch.cli.benchmark_localisation --config configs/monza.yaml \\
        --data data/localisation/monza_synth/racing [--figure replay.png]

``--figure`` needs matplotlib. A missing recording, map or config raises.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Replay a localisation recording and report accuracy"
    )
    parser.add_argument(
        "--benchmark-config",
        default=None,
        help="benchmark yaml (configs/benchmarks/<track>.yaml) bundling "
        "experiment name, data path, map and localisation settings",
    )
    parser.add_argument("--config", default=None, help="track config yaml")
    parser.add_argument(
        "--data",
        default=None,
        help="directory with control.npy + observations.npy",
    )
    parser.add_argument("--map", default=None, help="override map path")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--figure",
        default=None,
        help="save the 9-panel benchmark figure (particle map, BEV map, "
        "detections, execution times, score distribution, x/y/yaw error) "
        "to this PNG path",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device of the filter (default cuda)"
    )
    args = parser.parse_args(argv)

    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.localise.benchmarking import BenchmarkLocalisation

    if args.benchmark_config:
        from acmpc_tpu_torch.config.schema import LocalisationConfig, load_raw

        raw = load_raw(args.benchmark_config)
        loc_cfg = LocalisationConfig.from_config(raw["localisation"])
        data_path = args.data or raw["data_path"]
        map_path = args.map or raw["map_path"]
        seed = args.seed if args.seed is not None else raw.get("seed", 0)
        vehicle = None
    else:
        if not (args.config and args.data):
            parser.error("provide --benchmark-config, or --config and --data")
        cfg = load_config(args.config)
        loc_cfg = cfg.localisation
        data_path = args.data
        map_path = args.map or cfg.map_path
        seed = args.seed or 0
        vehicle = cfg.vehicle

    bench = BenchmarkLocalisation(
        data_path=data_path,
        map_path=map_path,
        localisation_cfg=loc_cfg,
        vehicle=vehicle,
        seed=seed,
        device=args.device,
    )
    visualiser = None
    if args.figure:
        from acmpc_tpu_torch.localise.benchmarking.visualisation import (
            LocalisationVisualiser,
        )

        visualiser = LocalisationVisualiser(bench.localiser, bench.tracker)
    summary = bench.run(visualiser=visualiser)
    if visualiser is not None:
        gt = [r["game_pose"][0] for r in bench._recording if "game_pose" in r]
        visualiser.save_figure(args.figure, gt_poses=gt)
        print(f"figure saved to {args.figure}")
    print(json.dumps(summary, indent=2))
    print(
        f"Percentage of time localised: {summary['percent_localised']:.1f}%\n"
        f"Average position error: {summary['mean_position_error_m']:.2f} m\n"
        f"Average rotation error: {summary['mean_rotation_error_deg']:.2f} deg"
    )
    return summary


if __name__ == "__main__":
    main()
