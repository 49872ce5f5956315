"""On the card: each cell runs through the command a check runs, prints a
result line of the contract's shape, and is correct. Skips without a
card (decided inside the test)."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_manifest(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    done = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 5),
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert out["device"]["busy_s"] > 0 and "breakdown" in out
