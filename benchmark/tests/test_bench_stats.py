"""The arithmetic of the end-to-end metrics: every request and every step
counts, so a planted stall moves the metric."""

import statistics

import pytest

from benchmark.harness import stats


def test_rate_is_all_work_over_all_time():
    steps = [0.01] * 100
    assert stats.rate(100 * 16384, sum(steps)) == pytest.approx(1638400.0)
    stalled = steps + [0.5]
    assert stats.rate(100 * 16384, sum(stalled)) < 0.67 * 1638400.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentiles_are_over_every_request():
    ms = [4.0] * 120 + [44.0] * 10
    assert stats.percentile(ms, 50) == 4.0
    assert stats.percentile(ms, 95) == 44.0
    # A planted stall in one request moves the tail, not the median.
    stalled = ms[:-1] + [400.0]
    assert stats.percentile(stalled, 100) == 400.0
    assert stats.percentile(stalled, 50) == 4.0
    slow = [4.0] * 60 + [8.0] * 70
    assert stats.percentile(slow, 50) == 8.0


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_uses_the_quartiles_of_statistics():
    v = [1.0, 1.02, 0.98, 1.01, 0.99, 1.05]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
