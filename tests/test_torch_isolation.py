"""The PyTorch port stands alone: importing it (and chip_smoke.py) pulls in
neither JAX nor the JAX package, and no code line of it names them."""

import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tokenize

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "acmpc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import acmpc_tpu_torch, chip_smoke
names = [m.name for m in pkgutil.walk_packages(acmpc_tpu_torch.__path__, "acmpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "acmpc_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_pulls_in_no_jax():
    # a subprocess: this test process already holds JAX (tests/conftest.py)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    # every module of the port was imported, this slice's among them
    assert len(result["modules"]) >= 71, result["modules"]
    for name in (
        "localise.track_map", "runtime.commands", "mpc.multi_track",
        "bench.lap_sweep", "bench.full_lap", "bench.lap_step",
        "perception.tracks", "perception.perceiver", "models.fpn_resnet18",
        "models.checkpoint", "ops.track_chain", "runtime.sim",
        "bench.perception_loop", "localise.particle_filter", "localise.localiser",
        "localise.benchmarking", "localise.benchmarking.recording",
        "localise.benchmarking.tracker", "localise.benchmarking.benchmark",
        "bench.locbench", "runtime.agent", "runtime.controller", "runtime.pid",
        "runtime.mailbox", "runtime.worker", "runtime.sim_bridge", "mapping.map_maker",
        "native", "recording.recorder", "utils.monitor", "cli.race", "cli.build_map",
        "bench.agent_loop",
    ):
        assert f"acmpc_tpu_torch.{name}" in result["modules"], name


def _code_only(path: pathlib.Path) -> str:
    """The file's code with comments and string literals removed."""
    tokens = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return " ".join(
        t.string
        for t in tokens
        if t.type not in (tokenize.COMMENT, tokenize.STRING)
        and not (hasattr(tokenize, "FSTRING_MIDDLE") and t.type == tokenize.FSTRING_MIDDLE)
    )


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    code = _code_only(path)
    assert not re.search(r"\bimport\s+jax\b|\bfrom\s+jax\b", code), path
    assert not re.search(r"\bacmpc_tpu\b(?!_torch)", code), path
