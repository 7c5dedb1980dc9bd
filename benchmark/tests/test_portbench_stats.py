"""The benchmark's arithmetic on synthetic data."""
import pytest

from benchmark import stats


def test_rate_over_the_window():
    assert stats.rate(4096 * 5, 2.0) == 10240.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9)]
    assert stats.union(iv) == [(0, 3), (5, 9)]
    assert stats.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (9, 10)]
    assert stats.covered(iv, 1, 6) == 3  # [1, 3] and [5, 6]


def test_busy_time_counts_a_stall_in_the_window():
    # 10 s window: kernels back to back for 2 s, a 6 s host stall, 2 s busy again
    kernels = [(0.01 * k, 0.01 * (k + 1)) for k in range(200)]
    kernels += [(8.0 + 0.01 * k, 8.0 + 0.01 * (k + 1)) for k in range(200)]
    assert stats.covered(kernels, 0.0, 10.0) == pytest.approx(4.0)
    assert max(e - s for s, e in stats.gaps(kernels, 0.0, 10.0)) == pytest.approx(6.0)
    # kernels reaching outside the window count only inside it, overlaps once
    assert stats.covered([(-1.0, 1.0), (0.5, 0.8), (9.5, 12.0)], 0.0, 10.0) == pytest.approx(1.5)


def test_idle_share_reads_the_traced_busy_time():
    from types import SimpleNamespace

    from benchmark import readers

    ctx = SimpleNamespace(trace=dict(busy_s=4.0, window_s=10.0))
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    assert readers.idle_share(SimpleNamespace(trace=dict(busy_s=0.0, window_s=10.0))) is None
    assert readers.idle_share(SimpleNamespace(trace=None)) is None
