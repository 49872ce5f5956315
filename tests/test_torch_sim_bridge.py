"""The port's simulator bridge and race CLI (CPU).

The protocol round trip and large-payload framing of
tests/test_sim_bridge.py against the port's server and client, a bridge
server process started with ``--device cpu``, and the race CLI's
``main`` for 5 steps with oracle perception on a temporary map and
config: in-process, and against an external simulator over the bridge.
"""

import os
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from acmpc_tpu.runtime.sim_bridge import _recv as j_recv
from acmpc_tpu.runtime.sim_bridge import _send as j_send
from acmpc_tpu_torch.cli import race
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.perception.camera import CameraInfo
from acmpc_tpu_torch.runtime.sim import SyntheticSimulator
from acmpc_tpu_torch.runtime.sim_bridge import RemoteSimulator, SimulatorServer, _recv, _send
from torch_agent_cases import ROOT, save_asymmetric_map

SMALL = {
    "image_width": 320,
    "image_height": 192,
    "n_rows_to_remove_bonnet": 160,
    "n_polyfit_points": 200,
    "use_localisation": "false",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small_track(tmp_path_factory):
    """A temporary map and monza's config rewritten to the e2e tests'
    sizes (camera 320x192, both MPCs at horizon 20, localisation off)
    pointing at it."""
    tmp = tmp_path_factory.mktemp("bridge")
    map_path = tmp / "track.npz"
    save_asymmetric_map(map_path)
    text = (ROOT / "configs" / "monza.yaml").read_text()
    for key, value in SMALL.items():
        text, n = re.subn(rf"^(\s*{key}:) .*$", rf"\g<1> {value}", text, flags=re.M)
        assert n == 1, key
    text, n = re.subn(r"^(\s*horizon:) \d+$", r"\g<1> 20", text, flags=re.M)
    assert n == 2
    text, n = re.subn(r"^(\s*map_path:) .*$", rf"\g<1> {map_path}", text, flags=re.M)
    assert n == 1
    cfg_path = tmp / "small.yaml"
    cfg_path.write_text(text)
    return cfg_path, map_path


class TinySim:
    clock = None
    pose = np.array([1.0, 2.0, 3.0])

    def __init__(self):
        self.n = 0
        self.closed = False

    def reset(self):
        self.n = 0
        return {"state": {"n": self.n}, "arr": np.arange(6.0)}

    def step(self, action):
        self.n += 1
        return {"state": {"n": self.n}, "arr": np.asarray(action) * 2.0}

    def close(self):
        self.closed = True


def test_bridge_protocol_roundtrip():
    """In-process server thread: reset/step/pose/close round trips carry
    numpy payloads faithfully."""
    tiny = TinySim()
    server = SimulatorServer(tiny)
    t = threading.Thread(target=server.serve, daemon=True)
    t.start()
    sim = RemoteSimulator(port=server.port)
    assert sim.clock is None
    obs = sim.reset()
    assert obs["state"]["n"] == 0
    np.testing.assert_allclose(obs["arr"], np.arange(6.0))
    obs = sim.step(np.array([1.0, 2.0, 3.0]))
    assert obs["state"]["n"] == 1
    np.testing.assert_allclose(obs["arr"], [2.0, 4.0, 6.0])
    np.testing.assert_allclose(sim.remote_pose(), [1.0, 2.0, 3.0])
    _send(sim._sock, {"cmd": "fly"})
    assert _recv(sim._sock) == {"error": "unknown cmd 'fly'"}
    sim.close()
    t.join(timeout=10)
    assert not t.is_alive() and tiny.closed


def test_bridge_framing_large_payload():
    """Framing survives messages larger than one TCP segment, and the
    port's frames are the JAX package's."""
    payload = {"big": np.random.default_rng(0).random((512, 512))}
    for send, recv in ((_send, _recv), (_send, j_recv), (j_send, _recv)):
        a, b = socket.socketpair()
        t = threading.Thread(target=lambda: send(a, payload))
        t.start()
        out = recv(b)
        t.join()
        np.testing.assert_allclose(out["big"], payload["big"])
        a.close()
        assert recv(b) is None  # peer closed
        b.close()


def test_bridge_server_process_on_the_cpu(small_track):
    cfg_path, map_path = small_track
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "acmpc_tpu_torch.runtime.sim_bridge", "--config", str(cfg_path),
         "--map", str(map_path), "--start-index", "50", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("ACMPC_SIM_BRIDGE PORT="), line + proc.stderr.read()
        sim = RemoteSimulator(port=int(line.strip().rsplit("=", 1)[1]))
        obs = sim.reset()
        assert obs["image"].shape == (192, 320, 3) and obs["drivable_mask"].any()
        obs = sim.step(np.array([0.0, 0.0, 1.0]))
        assert obs["state"]["distance_traveled"] > 0
        assert sim.remote_pose().shape == (3,)
        sim.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_race_cli_on_the_cpu(small_track, capsys):
    cfg_path, map_path = small_track
    obs = race.main(["--config", str(cfg_path), "--device", "cpu", "--steps", "5", "--oracle-perception"])
    assert obs["state"]["distance_traveled"] > 0
    out = capsys.readouterr().out
    assert out.startswith("finished: distance=") and "laps=0" in out


def test_race_cli_drives_a_remote_simulator(small_track, capsys):
    """``--remote``: the agent drives a simulator served in this process
    over the socket, on the wall clock, and its teardown closes the
    server."""
    cfg_path, map_path = small_track
    from acmpc_tpu_torch.config import load_config

    perception = load_config(cfg_path).perception
    sim = SyntheticSimulator(
        load_track_map(map_path, device="cpu"), CameraInfo.from_config(perception), start_index=50
    )
    server = SimulatorServer(sim)
    t = threading.Thread(target=server.serve, daemon=True)
    t.start()
    t0 = time.monotonic()
    obs = race.main(["--config", str(cfg_path), "--device", "cpu", "--steps", "5",
                     "--oracle-perception", "--remote", f"127.0.0.1:{server.port}"])
    t.join(timeout=30)
    assert not t.is_alive(), "the server outlived the agent's teardown"
    assert sim.distance > 0 and obs["state"]["distance_traveled"] == pytest.approx(sim.distance)
    assert time.monotonic() - t0 < 120
    assert capsys.readouterr().out.startswith("finished:")


def test_race_cli_has_no_dashboard_and_defaults_to_cuda():
    args = race.parse_arguments(["--config", "c.yaml"])
    assert args.device == "cuda" and not hasattr(args, "dashboard")
    with pytest.raises(SystemExit):
        race.parse_arguments(["--config", "c.yaml", "--dashboard"])
