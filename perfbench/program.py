"""The system under test, built from a configuration file through the
port's public entries, and the counters the port keeps.

It imports the program (``acmpc_tpu_torch``) when called, never when
loaded, as the drivers' set-up does: the reference, the metrics and the
tests import the benchmark without it.
"""

from __future__ import annotations


def build_mpc(config: dict, block: str, device):
    """The configured controller (``racing`` or ``mapping``) as
    ``build_mpc`` makes it for the agent."""
    from acmpc_tpu_torch.dynamics.vehicle import VehicleParams
    from acmpc_tpu_torch.mpc.spatial_mpc import build_mpc as build

    vehicle = VehicleParams.from_config(config["agent"]["vehicle"])
    return build(config["agent"][block]["control"], vehicle, device)


def launch_counts() -> dict:
    """The port's kernel launch counters, settled: ADMM chunks and
    chain-edges launches so far in this process."""
    from acmpc_tpu_torch.ops import admm_chunk, graph_loop, track_chain

    graph_loop.settle_launches()
    return {
        "chunks": sum(admm_chunk.admm_chunk.launches.values()),
        "chain_edges": sum(track_chain.chain_edges.launches.values()),
    }
