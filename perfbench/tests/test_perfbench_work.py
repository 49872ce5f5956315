"""The work and bound arithmetic against counts made by hand."""

from __future__ import annotations

import pytest

from perfbench.harness import busy_union, judged, merged, overlap
from perfbench.metrics._chunk_bound import chunk_bound, per_iteration_flops
from perfbench.metrics._fpn_flops import fpn_flops
from perfbench.metrics._peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S
from perfbench.metrics._qp_work import factor_flops, qp_flops

# monza racing at horizon 50: n = 3*50 + 2*49 variables, m = 3*50 + n rows,
# of which the last n are the box block
N50, M50 = 248, 398


def test_chunk_bound_at_horizon_50_by_hand():
    m_d = M50 - N50  # 150 dynamics rows
    operator = 4 * (248 * (248 + 150) + 150 * 248 + 248 + 248 + 3 * 398)  # W_s, A_d, g, c0, rho/l/u
    assert operator == 550376
    iterates = 4 * (248 + 2 * 398)
    seconds, bound = chunk_bound(N50, M50, 25, 1, 1, False, N50)
    assert bound == "bytes"
    assert seconds == pytest.approx((operator + 2 * iterates) / HBM_BYTES_PER_S, rel=1e-12)
    assert seconds == pytest.approx(0.1668e-6, rel=1e-3)
    # B = 256: 256 operators and iterates, 0.0427 ms
    seconds, _ = chunk_bound(N50, M50, 25, 256, 256, False, N50)
    assert seconds == pytest.approx(256 * (operator + 2 * iterates) / HBM_BYTES_PER_S, rel=1e-12)
    assert per_iteration_flops(N50, M50, N50) == 2 * 248 * 398 + 2 * m_d * 248 + 12 * 398 + 8 * 248


def test_dense_chunk_bound_counts_the_whole_operator():
    seconds, bound = chunk_bound(N50, M50, 25, 1, 1, False)
    operator = 4 * (248 * (248 + 398) + 398 * 248 + 248 + 3 * 398)
    assert seconds == pytest.approx((operator + 8 * (248 + 2 * 398)) / HBM_BYTES_PER_S)
    assert bound == "bytes"


def test_chunk_bound_turns_to_operations_when_iterations_dominate():
    seconds, bound = chunk_bound(N50, M50, 10_000, 256, 256, False, N50)
    assert bound == "operations"
    assert seconds == pytest.approx(256 * 10_000 * per_iteration_flops(N50, M50, N50) / FP32_FLOP_PER_S)


def test_qp_work_by_hand():
    assert factor_flops(N50, M50) == pytest.approx(2 * 150 * 248 ** 2 + 248 ** 3 / 3)
    assert qp_flops(N50, M50, 2, 75) == pytest.approx(2 * factor_flops(N50, M50) + 75 * per_iteration_flops(N50, M50, N50))


def _conv(h, w, cin, cout, k, stride=1):
    ho, wo = -(-h // stride), -(-w // stride)
    return ho, wo, 2.0 * ho * wo * cout * cin * k * k


def test_fpn_flops_by_hand():
    H, W = 736, 1280
    total = 0.0
    h, w, f = _conv(H, W, 3, 64, 7, 2)
    total += f
    h, w = h // 2, w // 2  # max pool
    cin, sizes = 64, []
    for c, s in ((64, 1), (128, 2), (256, 2), (512, 2)):
        h2, w2, f = _conv(h, w, cin, c, 3, s)
        total += f + _conv(h2, w2, c, c, 3)[2] + 2 * _conv(h2, w2, c, c, 3)[2]
        if s != 1 or cin != c:
            total += _conv(h, w, cin, c, 1, s)[2]
        h, w, cin = h2, w2, c
        sizes.append((h, w, c))
    for (h, w, c) in sizes:  # lateral 1x1 convolutions
        total += _conv(h, w, c, 256, 1)[2]
    for (h, w, _), ups in zip(sizes, (0, 1, 2, 3)):  # segmentation branches
        for i in range(max(1, ups)):
            total += _conv(h * 2 ** i, w * 2 ** i, 256 if i == 0 else 128, 128, 3)[2]
    h, w, _ = sizes[0]
    total += _conv(h, w, 128, 10, 1)[2]
    assert fpn_flops(H, W) == pytest.approx(total, rel=1e-12)
    assert fpn_flops(H, W) == pytest.approx(127.76e9, rel=1e-3)


def test_busy_inside_the_requests_by_hand():
    # device intervals (s): 0-2, 1-3, 5-6, 8-9; requests' host spans 0.5-2.5 and 5.5-8.5
    ivs = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0), ("d", 8.0, 9.0)]
    busy, gaps = busy_union(ivs)
    assert busy == pytest.approx(5.0) and gaps == [(3.0, 5.0), (6.0, 8.0)]
    spans = merged([(5.5, 8.5), (0.5, 1.5), (1.0, 2.5)])
    assert spans == [(0.5, 2.5), (5.5, 8.5)]
    assert overlap(merged([(s, e) for _, s, e in ivs]), spans) == pytest.approx(2.0 + 0.5 + 0.5)


def test_correct_needs_every_number_finite_and_within_its_limit():
    assert judged([("a", 0.5, 1.0), ("b", 3.0, 3.0)])
    assert not judged([])
    assert not judged([("a", 0.5, 1.0), ("b", 3.1, 3.0)])
    assert not judged([("a", float("nan"), 1.0)])
    assert not judged([("a", float("inf"), 1.0)])
