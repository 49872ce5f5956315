"""External-process simulator bridge: drive a sim the agent does NOT own.

Counterpart of ``acmpc_tpu/runtime/sim_bridge.py`` (host sockets):

* :class:`SimulatorServer` serves any ``SimulatorInterface`` over a
  localhost TCP socket (one frame in flight, strictly request/response,
  the lockstep contract of a game's capture loop);
* :class:`RemoteSimulator` is the client-side ``SimulatorInterface``
  adapter the agent drives. It deliberately exposes **no sim clock**
  (``clock = None``), so the runtime falls back to WALL-CLOCK temporal
  command selection (``runtime/controller.py``, ``desired_state``), the
  configuration used against a real-time game the process does not
  control.

Run the server standalone:

    python -m acmpc_tpu_torch.runtime.sim_bridge --config configs/monza.yaml \
        --map data/maps/monza.npz [--port 0] [--device cpu]

It prints ``ACMPC_SIM_BRIDGE PORT=<port>`` on stdout once listening, so a
parent process that requested an ephemeral port can discover it. The
synthetic simulator is host code; ``--device`` names where the track map
is loaded (CUDA unless given).

Framing: 4-byte big-endian length + pickle per message. Both ends are
first-party processes on localhost; the server binds 127.0.0.1 only.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Dict, Optional

import numpy as np

from acmpc_tpu_torch.runtime.sim import SimulatorInterface

_LEN = struct.Struct("!I")


def _send(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv(sock: socket.socket):
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    payload = _recv_exact(sock, n)
    return None if payload is None else pickle.loads(payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None  # peer closed
        buf += chunk
    return buf


class SimulatorServer:
    """Serve a SimulatorInterface to one client at a time over TCP."""

    def __init__(
        self,
        sim: SimulatorInterface,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._sim = sim
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    def serve(self, forever: bool = False) -> None:
        """Accept clients and answer their reset/step requests. With
        ``forever=False`` (default) the server returns after its first
        client disconnects — the lifetime a test subprocess wants."""
        try:
            while True:
                conn, _ = self._listener.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    closed = self._serve_client(conn)
                finally:
                    conn.close()
                if closed or not forever:
                    return
        finally:
            self._listener.close()
            self._sim.close()

    def _serve_client(self, conn: socket.socket) -> bool:
        """Returns True when the client requested a full shutdown."""
        while True:
            msg = _recv(conn)
            if msg is None:
                return False  # client vanished; allow reconnects
            cmd = msg.get("cmd")
            if cmd == "reset":
                _send(conn, self._sim.reset())
            elif cmd == "step":
                _send(conn, self._sim.step(np.asarray(msg["action"])))
            elif cmd == "pose":
                # ground-truth pose for test evaluation (the synthetic
                # sim exposes it; a real game would not)
                pose = getattr(self._sim, "pose", None)
                _send(conn, None if pose is None else np.asarray(pose))
            elif cmd == "close":
                _send(conn, {"ok": True})
                return True
            else:
                _send(conn, {"error": f"unknown cmd {cmd!r}"})


class RemoteSimulator(SimulatorInterface):
    """Client-side adapter: the agent's L0 seam over a socket.

    ``clock = None`` (inherited): command timing runs on the WALL clock,
    as it must against a process advancing in real time outside our
    control."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.create_connection((host, port), timeout=60.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def reset(self) -> Dict:
        _send(self._sock, {"cmd": "reset"})
        return self._expect_obs()

    def step(self, action: np.ndarray) -> Dict:
        _send(self._sock, {"cmd": "step", "action": np.asarray(action)})
        return self._expect_obs()

    def remote_pose(self) -> Optional[np.ndarray]:
        _send(self._sock, {"cmd": "pose"})
        return _recv(self._sock)

    def _expect_obs(self) -> Dict:
        obs = _recv(self._sock)
        if obs is None:
            raise ConnectionError("simulator server closed the connection")
        return obs

    def close(self):
        try:
            _send(self._sock, {"cmd": "close"})
            _recv(self._sock)
        except OSError:
            pass
        finally:
            self._sock.close()


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Serve a SyntheticSimulator over a localhost socket"
    )
    parser.add_argument("--config", required=True, help="track config yaml")
    parser.add_argument("--map", default=None, help="track map override")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--dt", type=float, default=0.05)
    parser.add_argument("--start-index", type=int, default=0)
    parser.add_argument(
        "--image-width", type=int, default=None, help="camera override"
    )
    parser.add_argument("--image-height", type=int, default=None)
    parser.add_argument("--bonnet-rows", type=int, default=None)
    parser.add_argument("--polyfit-points", type=int, default=None)
    parser.add_argument(
        "--device", default="cuda", help="where the track map is loaded"
    )
    parser.add_argument(
        "--serve-forever",
        action="store_true",
        help="keep accepting clients after the first disconnect",
    )
    args = parser.parse_args(argv)

    import dataclasses
    import sys

    from acmpc_tpu_torch.config import load_config
    from acmpc_tpu_torch.localise.track_map import load_track_map
    from acmpc_tpu_torch.perception.camera import CameraInfo
    from acmpc_tpu_torch.runtime.sim import SyntheticSimulator

    cfg = load_config(args.config)
    perc = cfg.perception
    overrides = {
        "image_width": args.image_width,
        "image_height": args.image_height,
        "n_rows_to_remove_bonnet": args.bonnet_rows,
        "n_polyfit_points": args.polyfit_points,
    }
    perc = dataclasses.replace(
        perc, **{k: v for k, v in overrides.items() if v is not None}
    )
    track_map = load_track_map(args.map or cfg.map_path, device=args.device)
    sim = SyntheticSimulator(
        track_map,
        CameraInfo.from_config(perc),
        dt=args.dt,
        start_index=args.start_index,
    )
    server = SimulatorServer(sim, port=args.port)
    print(f"ACMPC_SIM_BRIDGE PORT={server.port}", flush=True)
    sys.stdout.flush()
    server.serve(forever=args.serve_forever)


if __name__ == "__main__":
    main()
