"""The measured window's arithmetic: a rate between completion events."""

import pytest

from benchmark.harness import Window


def test_rate_counts_work_after_the_opening_event():
    w = Window(seconds=10.0)
    for t, a in ((100.0, 24), (102.0, 24), (104.0, 24), (106.0, 24)):
        w.add(t, a)
    assert w.span == (100.0, 106.0)
    assert w.rate() == pytest.approx(72 / 6.0)


def test_window_closes_at_the_last_event_before_its_length():
    w = Window(seconds=5.0)
    for t in (0.0, 2.0, 4.0, 6.0, 8.0):
        w.add(t, 10)
    assert w.closed(5.0) and not w.closed(4.9)
    assert [t for t, _ in w.inside()] == [0.0, 2.0, 4.0]
    assert w.rate() == pytest.approx(20 / 4.0)


def test_a_stall_lowers_the_rate():
    steady, stalled = Window(60.0), Window(60.0)
    for k in range(6):
        steady.add(2.0 * k, 24)
        stalled.add(2.0 * k + (3.0 if k >= 3 else 0.0), 24)
    assert stalled.rate() < steady.rate()
    assert stalled.rate() == pytest.approx(5 * 24 / 13.0)


@pytest.mark.parametrize("times", [[], [1.0]])
def test_fewer_than_two_events_give_no_rate(times):
    w = Window(10.0)
    for t in times:
        w.add(t, 1)
    assert w.rate() is None and w.span is None
