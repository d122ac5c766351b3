"""Rate, tail and idle arithmetic on synthetic timelines."""
import pytest

from harbench import timeline
from harbench.trace import Trace, short_name


def _steady(n, period, start=0.0):
    w = timeline.Window(start=start)
    for i in range(n):
        w.add(start + i * period, start + (i + 1) * period, 8)
    return w


def test_rate_is_all_the_work_over_all_the_window():
    w = _steady(100, 0.01)
    assert w.rate() == pytest.approx(800 / 1.0)
    assert w.seconds == pytest.approx(1.0)


def test_a_stall_moves_the_rate_and_the_tail():
    calm, stalled = _steady(100, 0.01), _steady(100, 0.01)
    i, c, u = stalled.done[50]
    stalled.done[50] = (i, c + 0.5, u)  # one request held half a second; the rest go on
    for k in range(51, 100):
        a, b, u = stalled.done[k]
        stalled.done[k] = (a + 0.5, b + 0.5, u)
    assert stalled.rate() < calm.rate() * 0.7
    assert timeline.percentile(stalled.latencies(), 100) > 0.5
    many = _steady(100, 0.01)
    for k in range(0, 100, 10):  # every tenth request stalls: the p95 sees it
        a, b, u = many.done[k]
        many.done[k] = (a, b + 0.2, u)
    assert timeline.percentile(many.latencies(), 95) > 0.1 > timeline.percentile(calm.latencies(), 95)


def test_no_number_without_completed_work():
    w = timeline.Window(start=0.0)
    with pytest.raises(timeline.NoWork):
        w.rate()
    with pytest.raises(timeline.NoWork):
        w.latencies()
    with pytest.raises(timeline.NoWork):
        timeline.percentile([], 95)


def test_percentile_interpolates_like_numpy():
    import numpy as np
    vals = [3.0, 1.0, 7.0, 2.0, 10.0, 4.0]
    for q in (0, 50, 95, 100):
        assert timeline.percentile(vals, q) == pytest.approx(float(np.percentile(vals, q)))


def test_busy_counts_overlaps_once_and_idle_includes_the_edges():
    ops = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)]
    assert timeline.busy_seconds(ops, 0.0, 10.0) == pytest.approx(4.0)
    assert timeline.idle_pct(ops, 0.0, 10.0) == pytest.approx(60.0)
    assert timeline.gaps(ops, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert timeline.busy_seconds(ops, 2.5, 6.5) == pytest.approx(2.0)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    device = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    host = [("outer", 0.0, 3.0), ("cudaStreamSynchronize", 1.1, 1.9)]
    tr = Trace(device, host, 0.0, 3.0)
    assert tr.busy_s() == pytest.approx(2.0)
    assert dict(tr.idle_gaps()) == {"cudaStreamSynchronize": pytest.approx(1.0)}
    assert tr.kernel_seconds("k") == (pytest.approx(2.0), 2)


def test_kernel_names_are_shortened():
    assert short_name("void flash_attn_kernel<true, (int)64>(bf16*, float*)") == "flash_attn_kernel<true, (int)64>"
