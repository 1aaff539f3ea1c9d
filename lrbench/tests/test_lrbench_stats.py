"""The metric arithmetic: percentiles, rates over a window, device
intervals and their idle gaps."""

import math

import pytest

from lrbench import stats


def test_p95_is_nearest_rank_over_every_value():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 100) == 3


def test_p95_counts_a_failed_request_as_missing():
    values = [10.0] * 19 + [math.inf]
    assert stats.percentile(values, 95) == 10.0
    assert stats.percentile(values + [math.inf], 95) == math.inf


def test_rate_over_a_window_with_a_stall():
    # 10 items done by t = 1 s, then a stall, the last item ending at 4 s
    assert stats.rate(11, 0.0, 4.0) == pytest.approx(2.75)
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)


def test_union_and_idle_of_device_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.merge_intervals(iv) == [(0, 15), (20, 31)]
    assert stats.busy_time(iv, 0, 50) == 26
    assert stats.busy_time(iv, 12, 25) == 8
    assert stats.idle_gaps(iv, 0, 50) == [(15, 20), (31, 50)]
    assert stats.idle_gaps(iv, -5, 12) == [(-5, 0)]
