"""The end-to-end metrics' arithmetic and the detect kernel's byte count."""

import math

import pytest

from benchmark import roofline, stats


def test_percentile_counts_misses_as_infinite():
    ages = [10.0] * 18 + [math.inf] * 2       # 2 of 20 never served
    assert stats.percentile(ages, 0.5) == 10.0
    assert stats.percentile(ages, 0.95) == math.inf
    assert stats.reported(stats.percentile(ages, 0.95)) == stats.NEVER_MS
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.5
    assert stats.percentile([5.0], 0.95) == 5.0


def test_ages_run_from_due_and_count_every_due_cpi():
    due = {10: 1.0, 11: 1.5, 12: 2.0, 13: 2.5, 14: 9.0}
    held = {10: 1.25, 11: 1.5125, 13: 2.6, 14: 9.1}
    # CPI 12 never served, CPI 14 due after the window: not counted.
    ages = stats.ages_ms(due, held, t_end=3.0)
    assert ages[0] == pytest.approx(250.0) and ages[1] == pytest.approx(12.5)
    assert ages[2] == math.inf and ages[3] == pytest.approx(100.0)
    assert len(ages) == 4
    # A ring dropped samples of CPI 11: it and every later CPI are lost.
    lost = stats.ages_ms(due, held, t_end=3.0, lost_from=11)
    assert lost[0] == pytest.approx(250.0)
    assert all(a == math.inf for a in lost[1:])


def test_throughput_counts_the_cpis_held_inside_the_window():
    held = [0.5, 1.0, 1.5, 2.0, 3.0, 3.01]
    # 4 CPIs held in [1, 3] s, 1.5 M samples each, over 2 s.
    assert stats.throughput_msps(held, 1.0, 3.0, 1_500_000) == \
        pytest.approx(3.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_detect_bytes_of_the_default_map():
    # 301 x 411 cells: the complex64 map and the float32 mask in, the dB
    # map and the keep mask out, 20 B a cell; the column scale; noise and
    # rawmax.
    assert roofline.detect_bytes(301, 411) == 301 * 411 * 20 + 411 * 4 + 8
    # The 0.739 us floor PERF.md gives the kernel at 3.35 TB/s.
    assert roofline.detect_bytes(301, 411) / roofline.HBM_BYTES_PER_S == \
        pytest.approx(0.739e-6, rel=1e-3)
    assert roofline.detect_roofline_pct(301, 411, 7.39e-6) == \
        pytest.approx(10.0, rel=1e-3)


def test_offset_gap_is_the_least_change_that_moves_the_peak():
    from benchmark.judge import offset_gap_db

    s0, s1, s2 = 17.0, 20.0, 18.0          # offset (s0 - s2) / 2b = 0.1
    assert offset_gap_db(s0, s1, s2, 0.09, 0.11) == 0.0
    gap = offset_gap_db(s0, s1, s2, -0.01, 0.0)       # the cell's centre
    # Moving each cell by the gap, each the way that pulls the offset to 0,
    # lands on it; any less does not reach.
    for e in (gap, 0.999 * gap):
        a, b = (s0 + e) - (s2 - e), (s0 + e) - 2 * (s1 - 0.0) + (s2 - e)
        off = a / (2 * b)
        assert (off <= 1e-12) == (e == gap)
    assert gap == pytest.approx(0.5)
    # A flat peak moves far for little: its gap is small.
    assert offset_gap_db(19.99, 20.0, 19.98, 0.3, 0.31) < 0.01
