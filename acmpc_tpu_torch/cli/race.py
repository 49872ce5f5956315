"""Race CLI: drive the agent around a track.

Counterpart of ``acmpc_tpu/cli/race.py``. The default simulator is the
built-in SyntheticSimulator over the configured track map; an external
simulator process is driven over a socket with ``--remote``; ``--dashboard``
serves the MJPEG dashboard while the agent runs. Runs on the card unless
``--device`` names another device:

    python -m acmpc_tpu_torch.cli.race --config configs/monza.yaml --steps 400 [--dashboard]
"""

from __future__ import annotations

import argparse


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Race an acmpc_tpu_torch agent")
    parser.add_argument("--config", required=True, help="track config yaml")
    parser.add_argument(
        "--steps", type=int, default=2000, help="max simulator steps"
    )
    parser.add_argument(
        "--oracle-perception",
        action="store_true",
        help="bypass the segmentation network with the simulator's "
        "ground-truth masks",
    )
    parser.add_argument(
        "--map", default=None, help="override the track map path"
    )
    parser.add_argument(
        "--dashboard", action="store_true", help="serve the MJPEG dashboard"
    )
    parser.add_argument(
        "--remote",
        default=None,
        metavar="HOST:PORT",
        help="drive an EXTERNAL simulator process served by "
        "`python -m acmpc_tpu_torch.runtime.sim_bridge` instead of the "
        "in-process synthetic sim; command timing then runs on the "
        "wall clock (the real-time-game configuration)",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device of the agent (default cuda)"
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)

    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.runtime import Agent, SyntheticSimulator

    cfg = load_config(args.config)
    map_path = args.map or cfg.map_path
    if args.remote:
        from acmpc_tpu_torch.runtime.sim_bridge import RemoteSimulator

        host, _, port = args.remote.rpartition(":")
        sim = RemoteSimulator(host or "127.0.0.1", int(port))
    else:
        track_map = load_track_map(map_path, device=args.device)
        sim = SyntheticSimulator(track_map, CameraInfo.from_config(cfg.perception))
    agent = Agent(
        cfg,
        sim,
        use_oracle_perception=args.oracle_perception,
        map_path=map_path,
        device=args.device,
    )
    dashboard = None
    if args.dashboard:
        from acmpc_tpu_torch.dashboard import Dashboard

        dashboard = Dashboard(agent, sim)
        dashboard.start()
        print(f"dashboard: http://localhost:{dashboard.port}/")
    try:
        obs = agent.run(max_steps=args.steps)
    finally:
        if dashboard is not None:
            dashboard.stop()
    state = obs["state"]
    print(
        f"finished: distance={state['distance_traveled']:.0f} m, "
        f"laps={state['completed_laps']}, "
        f"speed={state['speed_kmh']:.0f} km/h"
    )
    return obs


if __name__ == "__main__":
    main()
