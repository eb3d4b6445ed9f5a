"""The percentile, spread, interval and work arithmetic."""

import statistics

import numpy as np
import pytest

from benchmark import stats, work


def test_percentile_matches_numpy():
    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 110):
        xs = rng.rand(n).tolist()
        for q in (0, 50, 90, 100):
            assert stats.percentile(xs, q) == pytest.approx(
                np.percentile(xs, q))
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (10, 12)]
    assert stats.union_length(iv, 0, 11) == pytest.approx(3 + 2 + 1)
    assert stats.gaps(iv, 0, 11) == [(3, 5), (7, 10)]
    assert stats.gaps([], 0, 1) == [(0, 1)]
    assert stats.union_length([(2, 1)], 0, 5) == 0


def test_strided_counts_incumbent_samples():
    assert list(work.strided(0, [0, 1, 8, 9], 8)) == [0, 1, 1, 2]
    assert list(work.strided(5, [3, 4], 8)) == [0, 1]
    assert list(work.strided(5, [3], 1)) == [3]


def test_k1_work_by_hand():
    ex, de, nb = work.k1_launch([2], [3], [4], [1], nside=False,
                                record_steps=0)
    assert ex == 2 * (4 * 5 * 6 + 6) and de == 2 * 4 * 4
    assert nb == 6 + 4 * 4 + 4 * (11 * 3 + 7 * 2)
    ex, de, nb = work.k1_launch([2], [3], [4], [0], nside=True,
                                record_steps=5)
    assert ex == 2 * 4 * (2 * 6 + 9) and de == 2 * 4 * 9
    assert nb == 6 + 5 * 9 + 4 * (11 * 3 + 7 * 2) + 4 * 3 * 5
    # a done instance iterates no more and needs nothing
    assert work.k1_launch([2], [3], [0], [0], False, 0) == (0.0, 0.0, 0.0)


def test_k2_work_matches_a_forward_count():
    # T 20 tokens of 5, E 128, 2 layers, FF 512: the shipped policy
    ex, de, nb = work.k2_launch(10, 100, 20, 5, 128, 2, 512)
    fma = 20 * 5 * 128 + 2 * (20 * 128 * 384 + 2 * 400 * 128
                              + 20 * 128 * 128 + 2 * 20 * 128 * 512) \
        + 2560 * 256 + 256 * 128 + 128 * 16 + 16
    assert ex == 0 and de == 2 * fma * 10
    assert nb > 4 * (10 * 100 + 10)


def test_least_time_takes_the_larger_bound():
    t, b = work.least_time(work.PEAKS["exact"], 0, 1.0)
    assert b == "operations" and t == pytest.approx(1.0)
    t, b = work.least_time(0, 0, work.HBM_BYTES_S)
    assert b == "bytes" and t == pytest.approx(1.0)
    t, _ = work.least_time(work.PEAKS["exact"], work.PEAKS["dense"], 0)
    assert t == pytest.approx(2.0)
