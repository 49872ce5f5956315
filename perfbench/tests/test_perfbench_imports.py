"""Nothing a run imports, nor the reference, is JAX, Flax or the JAX
package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "acmpc_tpu_torch" not in tops, path


def test_the_whole_name_is_compared():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "acmpc_tpu")
    names = ["acmpc_tpu_torch", "acmpc_tpu_torch.ops", "jaxtyping", "flaxen"]
    assert not [m for m in names if m.split(".")[0] in harness.FORBIDDEN]
    assert [m for m in ("jax.numpy", "acmpc_tpu.mpc") if m.split(".")[0] in harness.FORBIDDEN]


def test_a_run_leaves_no_jax_module_loaded():
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "import perfbench.drivers.control, perfbench.drivers.sweep, perfbench.drivers.camera\n"
        "import acmpc_tpu_torch.mpc.spatial_mpc, acmpc_tpu_torch.bench.lap_sweep\n"
        "import acmpc_tpu_torch.perception.perceiver, acmpc_tpu_torch.runtime.controller\n"
        "print(harness.forbidden_modules())\n" % str(ROOT)
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
