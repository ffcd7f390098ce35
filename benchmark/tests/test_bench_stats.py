"""The percentile, rate and device-union arithmetic on synthetic times."""

import pytest

from benchmark import stats


def test_percentile_and_intervals():
    stamps = [0.0, 10.0, 20.0, 31.0, 41.0, 60.0]
    iv = stats.intervals(stamps)
    assert iv == [10.0, 10.0, 11.0, 10.0, 19.0]
    assert stats.percentile(iv, 50) == 10.0
    # linear between the two closest ranks: rank 0.95 · 4 = 3.8
    assert stats.percentile(iv, 95) == pytest.approx(11.0 + 0.8 * 8.0)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_rate():
    assert stats.rate(65536 * 100, 2.0) == 3276800.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_busy_and_gaps():
    spans = [(0, 4), (2, 6), (8, 9), (9, 10), (15, 16), (3, 5)]
    assert stats.union(spans) == [(0, 6), (8, 10), (15, 16)]
    busy, window = stats.busy(spans)
    assert (busy, window) == (9, 16)
    assert stats.gaps(spans) == [(10, 15), (6, 8)]
    assert stats.busy([]) == (0.0, 0.0)
    assert stats.gaps([(0, 1)]) == []
