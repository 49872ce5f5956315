"""The batch sweep (``bench/batch_sweep.py``) on the CPU at a short
horizon: one row per B with every key, the windows of ``bench.py``'s
``_mixed_refs``, and B = 1 through ``get_control``."""

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.bench import batch_sweep

KEYS = {
    "stage", "batch", "horizon", "device", "cold_ms", "blocked_p50_ms", "blocked_p99_ms",
    "chained_ms_per_step", "solves_per_s", "chained_solves_per_s", "max_memory_allocated_bytes",
    "plan", "chunk_launches_per_step", "solved_per_B", "chained_solved_per_B", "card",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_mixed_refs_match_bench_py():
    import bench
    import __graft_entry__ as ge

    for batch in (1, 6):
        got = batch_sweep.mixed_refs(bench.HORIZON, batch)
        want = (
            np.asarray(ge._reference_window(bench.HORIZON))[None]
            if batch == 1 else np.asarray(bench._mixed_refs(ge, batch))
        )
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_sweep_rows_at_b1_and_b2(capsys):
    rows = list(batch_sweep.sweep([1, 2], horizon=16, device="cpu", steps=2, chain=2))
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == KEYS
        assert r["stage"] == "batch_latency" and r["device"] == "cpu"
        assert r["solved_per_B"] == 1.0 and r["chained_solved_per_B"] == 1.0
        assert r["blocked_p99_ms"] >= r["blocked_p50_ms"] > 0 and r["solves_per_s"] > 0
        assert r["chunk_launches_per_step"] == 0  # the CPU runs the plain chunk
        assert r["plan"]["variant"] == "cluster" and r["max_memory_allocated_bytes"] is None
    assert batch_sweep.main(["--batches", "1", "--horizon", "16", "--steps", "1",
                             "--chain", "1", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1 and '"batch": 1' in line[0]


def test_stages_name_bench_py_functions():
    assert batch_sweep.BATCHES == (1, 8, 32, 256, 4096) and batch_sweep.WIDE == (512, 1024, 2048)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(batch_sweep.sweep([1]))


def test_hairpins_past_a_kilometre_are_unsolved_in_both_packages():
    # bench.py's windows at large B: hairpins of radius 30 + 2i m. Both
    # packages solve the 542 m one (i = 256) and leave the 1,006 m one
    # (i = 488) unsolved, so solved / B falls with B by the windows and
    # not by the port
    import jax.numpy as jnp

    import __graft_entry__ as ge

    refs = batch_sweep.mixed_refs(50, 1024)
    ours, ref = batch_sweep.make_mpc(50, "cpu"), ge._make_mpc(50)
    for i, solvable in ((768, True), (1000, False)):
        s, _ = ours.get_control(ours.initial_state(), torch.as_tensor(refs[i]))
        j, _ = ref.jitted_get_control(ref.initial_state(), jnp.asarray(refs[i]))
        assert bool(s.solved) == bool(j.solved) == solvable, i
