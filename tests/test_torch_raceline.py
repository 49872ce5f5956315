"""The minimum-curvature raceline: the port's ``utils/raceline.py`` and
``cli/raceline.py`` against the JAX package's on the CPU.

The raceline is three whole-track box QPs solved by ADMM to a 1e-3
residual tolerance, and they are ill-conditioned: P = 2 J'J, and sliding
the line sideways along a straight barely changes its curvature. So the
stopping rule pins the curvature profile but not alpha: two runs of the
same code that reduce in another order (the CPU at one and at three
intra-op threads, or the card) stop at lines whose curvatures agree to a
few percent of the track's largest while alpha moves by up to the better
part of the 1 m margin on monza at 1,953 points (``spread`` measures it:
``python tests/test_torch_raceline.py --spread``). The port is held to
what the algorithm fixes: every QP solved; the curvature profile, each
point within a tenth of the largest |kappa| of JAX's line; the summed
squared curvature within 5e-3 relative; alpha within the 1 m margin; and
the bound, which alpha may leave by the primal residual, by at most what
JAX does plus 1e-3.

The JAX side of the shipped maps is the committed fixture
``fixtures/torch_raceline_jax.npz``: JAX's alpha for the seven maps at the
CLI's 600-point cap and for monza at every 6th point (1,953 points,
``tools/build_assets.py``'s stride), written by ``write_fixture``. Rewrite
it (about two minutes) with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_raceline.py --write-fixture
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import pytest
import torch

from acmpc_tpu_torch.cli import raceline as cli
from acmpc_tpu_torch.localise.track_map import load_track_map
from acmpc_tpu_torch.ops.admm_chunk import plan_chunk, split_layout, split_plan
from acmpc_tpu_torch.utils import raceline as rl

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_raceline_jax.npz"
TRACKS = ("monza", "spa", "silverstone", "nordschleife", "vallelunga", "bathurst", "yas_marina")
# (track, stride): the CLI's cap (stride None) on every map, and monza at
# the stride that built the shipped data/racelines/*.npz
CASES = tuple((t, None) for t in TRACKS) + (("monza", 6),)
MARGIN = 1.0
ALPHA_TOL = MARGIN
KAPPA_SHARE = 0.1
CURVATURE_RTOL = 5e-3
VIOLATION_SLACK = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def case_key(track: str, stride: int | None) -> str:
    return f"{track}/{'cap' if stride is None else f'stride{stride}'}"


def case_inputs(track: str, stride: int | None):
    """The centreline and half widths the CLI (or ``build_assets``'
    stride) gives the raceline of a shipped map."""
    tm = load_track_map(ROOT / "data" / "maps" / f"{track}.npz", device="cpu")
    centre, left = tm.centre.numpy(), tm.left.numpy()
    return cli.corridor(centre, left, stride or cli.cap_stride(len(centre)))


def violation(alpha, half_width, margin=MARGIN) -> float:
    """How far |alpha| exceeds its bound, at most (0 inside)."""
    return max(0.0, float(np.max(np.abs(alpha) - np.maximum(half_width - margin, 0.0))))


def curvature(centre, alpha) -> np.ndarray:
    return rl.offset_curvature(
        torch.tensor(np.asarray(centre, np.float32)), torch.tensor(np.asarray(alpha, np.float32))
    ).numpy()


def assert_matches_jax(centre, half, alpha, want):
    """alpha against JAX's by what the QPs fix (see the module docstring)."""
    assert alpha.shape == want.shape == (len(centre),)
    k, k_jax = curvature(centre, alpha), curvature(centre, want)
    assert np.abs(k - k_jax).max() <= KAPPA_SHARE * np.abs(k_jax).max()
    assert float((k**2).sum()) == pytest.approx(float((k_jax**2).sum()), rel=CURVATURE_RTOL)
    np.testing.assert_allclose(alpha, want, atol=ALPHA_TOL, rtol=0)
    assert violation(alpha, half) <= violation(want, half) + VIOLATION_SLACK


def _asymmetric_centre(m):
    from test_localise import make_asymmetric_map

    return np.asarray(make_asymmetric_map(m).centre)


def test_curvatures_and_normals_match_jax():
    import jax.numpy as jnp

    from acmpc_tpu.utils import raceline as jrl

    rng = np.random.default_rng(0)
    centre = _asymmetric_centre(120)
    pts = (centre + rng.normal(scale=0.5, size=centre.shape)).astype(np.float32)
    for name in ("menger_curvature", "signed_curvature", "_unit_normals"):
        got = getattr(rl, name)(torch.tensor(pts)).numpy()
        want = np.asarray(getattr(jrl, name)(jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_jacobian_matches_jax_jacobian():
    import jax
    import jax.numpy as jnp

    from acmpc_tpu.utils import raceline as jrl

    centre = _asymmetric_centre(120).astype(np.float32)
    alpha = np.random.default_rng(1).uniform(-3, 3, len(centre)).astype(np.float32)
    normals = np.asarray(jrl._unit_normals(jnp.asarray(centre)))

    def jax_kappa(a):
        return jrl.signed_curvature(jnp.asarray(centre) + a[:, None] * jnp.asarray(normals))

    def kappa(a):
        return rl.signed_curvature(torch.tensor(centre) + a[:, None] * torch.tensor(normals))

    want = np.asarray(jax.jacobian(jax_kappa)(jnp.asarray(alpha)))
    got = torch.func.jacfwd(kappa)(torch.tensor(alpha)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    # banded: each curvature sees its point and its two neighbours
    i, j = np.nonzero(got)
    assert set(((j - i) % len(centre)).tolist()) <= {0, 1, len(centre) - 1}


def test_calculate_raceline_matches_live_jax():
    from acmpc_tpu.utils.raceline import calculate_raceline as jax_raceline

    centre = _asymmetric_centre(120).astype(np.float32)
    half = np.full(len(centre), 5.0, np.float32)
    line_j, alpha_j = jax_raceline(centre, half, margin=MARGIN, return_alpha=True)
    r = rl.solve_raceline(centre, half, margin=MARGIN, device="cpu")
    alpha = r.alpha.numpy()
    assert_matches_jax(centre, half, alpha, np.asarray(alpha_j))
    np.testing.assert_allclose(r.line.numpy(), np.asarray(line_j), atol=ALPHA_TOL, rtol=0)
    assert len(r.solutions) == 3
    assert all(int(s.status) in (1, 3) for s in r.solutions)


def test_shipped_map_matches_the_fixture():
    fixture = np.load(FIXTURE)
    track, stride = "vallelunga", None
    centre, half = case_inputs(track, stride)
    key = case_key(track, stride)
    np.testing.assert_array_equal(fixture[f"{key}/centre"], centre.astype(np.float32))
    line, alpha = rl.calculate_raceline(centre, half, margin=MARGIN, return_alpha=True, device="cpu")
    assert_matches_jax(centre, half, alpha, fixture[f"{key}/alpha"])
    assert line.shape == (len(centre), 2) and np.isfinite(line).all()


def test_fixture_holds_every_case():
    fixture = np.load(FIXTURE)
    for track, stride in CASES:
        key = case_key(track, stride)
        centre = fixture[f"{key}/centre"]
        assert fixture[f"{key}/alpha"].shape == (len(centre),)
        assert len(centre) <= cli.MAX_POINTS if stride is None else len(centre) > cli.MAX_POINTS
    assert len(fixture["monza/stride6/centre"]) == 1953


def test_raceline_cuts_corners():
    # tests/test_tools.py::test_raceline_cuts_corners on the port
    centre = _asymmetric_centre(600)
    raceline = rl.calculate_raceline(centre, half_width=5.0, margin=0.5, device="cpu")
    assert raceline.shape == centre.shape
    offsets = np.linalg.norm(raceline - centre, axis=1)
    assert offsets.max() <= 4.6
    k_centre = rl.menger_curvature(torch.tensor(centre, dtype=torch.float32)).abs().mean()
    k_race = rl.menger_curvature(torch.tensor(raceline)).abs().mean()
    assert k_race < k_centre


@pytest.mark.parametrize("n_points", [586, 1953])
def test_raceline_qps_take_the_split_kernel(n_points):
    # n = m = N. As a dense operator (W and A, 3 N^2 floats) no cluster
    # holds it, and the split kernel would take it with 16 CTAs
    plan = plan_chunk(n_points, n_points, 1)
    assert (plan.variant, plan.cluster) == ("split", 16)
    lay = split_layout(n_points, n_points, 16)
    assert plan.smem_bytes == lay.bytes <= 232_448
    # a stage holds at least one W row (2N floats: at N = 1,953 longer
    # than the default 8 KB stage, which is then raised)
    assert lay.stage_floats >= 2 * n_points + 3
    assert 0 < lay.res_w <= lay.rows_w
    # the raceline hands the solver A = I as the box block, so its chunks
    # take W_s = K^-1 (N^2 floats): a cluster of 8 at 586 points; at 1,953
    # the split kernel, streaming W_s alone
    box = plan_chunk(n_points, n_points, 1, n_points)
    if n_points == 586:
        assert (box.variant, box.cluster, box.box) == ("cluster", 8, True)
    else:
        assert box == split_plan(n_points, n_points, 16, n_b=n_points)
        box_lay = split_layout(n_points, n_points, 16, n_b=n_points)
        assert box_lay.stage_floats >= n_points + 3 and box_lay.rows_a == 0
        assert 0 < box_lay.res_w < box_lay.rows_w


def test_raceline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rl.solve_raceline(np.zeros((8, 2)), 5.0)


def write_fixture(path: pathlib.Path = FIXTURE) -> dict:
    """JAX's raceline of every case, with the centreline it started from."""
    import time

    from acmpc_tpu.utils.raceline import calculate_raceline as jax_raceline

    out, report = {}, {}
    for track, stride in CASES:
        centre, half = case_inputs(track, stride)
        t0 = time.perf_counter()
        _, alpha = jax_raceline(centre, half, margin=MARGIN, return_alpha=True)
        key = case_key(track, stride)
        out[f"{key}/centre"] = centre.astype(np.float32)
        out[f"{key}/alpha"] = np.asarray(alpha, np.float32)
        report[key] = {
            "points": len(centre),
            "violation_m": violation(alpha, half),
            "cpu_s": time.perf_counter() - t0,
        }
    np.savez_compressed(path, **out)
    return report


def spread(track: str = "monza", stride: int = 6, threads=(1, 3)) -> dict:
    """The port's raceline of one fixture case on the CPU at several
    intra-op thread counts (another reduction order each), against the
    fixture: alpha's and the curvature's largest differences."""
    fixture = np.load(FIXTURE)
    key = case_key(track, stride)
    centre, half = case_inputs(track, stride)
    want = fixture[f"{key}/alpha"]
    k_jax = curvature(centre, want)
    out = {}
    for n in threads:
        torch.set_num_threads(n)
        r = rl.solve_raceline(centre, half, margin=MARGIN, device="cpu")
        alpha = r.alpha.numpy()
        k = curvature(centre, alpha)
        out[f"threads{n}"] = {
            "iterations": [int(sol.iterations) for sol in r.solutions],
            "alpha_max_abs_diff_m": float(np.abs(alpha - want).max()),
            "kappa_max_abs_diff": float(np.abs(k - k_jax).max()),
            "kappa_max_abs_jax": float(np.abs(k_jax).max()),
            "squared_curvature_rel_diff": float((k**2).sum() / (k_jax**2).sum() - 1.0),
        }
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--write-fixture", action="store_true")
    mode.add_argument("--spread", action="store_true", help="monza at 1,953 points, 1 and 3 threads")
    args = ap.parse_args()
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    print(json.dumps(write_fixture() if args.write_fixture else spread(), indent=1))
