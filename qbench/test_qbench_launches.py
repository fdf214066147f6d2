"""Device time charged to the launching span, and the idle time split at
each launch, on synthetic events."""

import pytest

from qbench import launches
from qbench.launches import OUTSIDE, UNLINKED

# thread 1 opens solve > eval > (rule, classify), then advance > split;
# thread 2 holds a range of its own
RANGES = [
    (1, 0.0, 10.0, "qbench.solve"),
    (1, 1.0, 4.0, "core.eval"),
    (1, 1.0, 2.0, "core.rule"),
    (1, 2.5, 3.5, "core.classify"),
    (1, 5.0, 8.0, "core.advance"),
    (1, 6.0, 7.0, "core.split"),
    (2, 0.0, 10.0, "other.thread"),
]


def test_innermost_range_on_the_launching_thread():
    queries = [(1, 1.5), (1, 2.2), (1, 3.0), (1, 5.5), (1, 6.5), (1, 9.0), (1, 11.0), (2, 1.5),
               (3, 1.5), (1, 1.0), (1, 2.0)]
    assert launches.innermost(RANGES, queries) == [
        "core.rule", "core.eval", "core.classify", "core.advance", "core.split", "qbench.solve",
        OUTSIDE, "other.thread", OUTSIDE, "core.rule", "core.rule"]
    # the answer does not depend on the order of the ranges or the queries
    assert launches.innermost(RANGES[::-1], queries[::-1]) == launches.innermost(
        RANGES, queries)[::-1]


def test_charge_picks_the_launching_range_not_the_running_one():
    # each op runs well after its launch, under another host span
    ops = [(0, "gm_eval_kernel", 4.0, 5.0, 11), (0, "sort", 6.0, 6.5, 12),
           (0, "gather", 8.5, 9.0, 13), (0, "copy", 9.0, 9.5, 14), (1, "memset", 2.0, 2.1, 15)]
    found = {11: (1, 1.5), 12: (1, 2.8), 13: (1, 6.2), 15: (2, 1.0)}  # 14 has no launch
    assert launches.charge(ops, found, RANGES) == [
        "core.rule", "core.classify", "core.split", UNLINKED, "other.thread"]


def test_charged_and_unlinked_seconds_add_up_to_the_operations():
    ops = [(d, "k", 0.1 * i, 0.1 * i + 0.05 * (1 + i % 3), i) for i in range(40) for d in (0, 1)]
    found = {i: (1, 0.3 * i) for i in range(40) if i % 7}
    by = launches.seconds_by_span(ops, launches.charge(ops, found, RANGES))
    assert sum(by.values()) == pytest.approx(sum(b - a for _, _, a, b, _ in ops))
    assert by[UNLINKED] == pytest.approx(sum(b - a for _, _, a, b, i in ops if i % 7 == 0))
    assert OUTSIDE in by  # launches past the solve's range


def test_idle_issued_splits_each_gap_at_the_launch_that_ends_it():
    window = (0.0, 10.0)
    ops = [
        (0, "a", 0.0, 1.0, 1),
        (0, "b", 2.0, 3.0, 2),  # gap (1, 2): launched at 0.5, before it: all issued
        (0, "c", 5.0, 6.0, 3),  # gap (3, 5): launched at 4.0, inside it: 1.0 issued
        (0, "d", 5.0, 5.5, 4),  # also starts at 5, launched later: the earliest counts
        (0, "e", 7.0, 8.0, 5),  # gap (6, 7): no launch known: counts as launched at 7
        #                         gap (8, 10): the window's end, nothing ends it
        (1, "f", 4.0, 6.0, 6),  # device 1: gap (0, 4) launched at 3.5; gap (6, 10) at the end
    ]
    found = {1: (1, 0.0), 2: (1, 0.5), 3: (1, 4.0), 4: (1, 4.8), 6: (1, 3.5)}
    got = launches.idle_issued(ops, found, window)
    assert got[0] == pytest.approx((1.0 + 2.0 + 1.0 + 2.0, 1.0 + 1.0))
    assert got[1] == pytest.approx((4.0 + 4.0, 0.5))


def test_readings_shares_of_the_window():
    window = (0.0, 10.0)
    ops = [(0, "rule", 1.0, 3.0, 1), (0, "rule", 2.0, 4.0, 2), (0, "split", 6.0, 7.0, 3),
           (1, "split", 7.0, 8.0, 4), (1, "lost", 8.0, 9.0, 5), (1, "early", -2.0, 1.0, 6)]
    found = {1: (1, 1.1), 2: (1, 1.2), 3: (1, 6.5), 4: (1, 6.6), 6: (1, -3.0)}
    r = launches.readings(ops, found, RANGES, window, [0, 1])
    # clipped to the window: the early op keeps (0, 1), launched before any range
    assert r["device_by_span"] == pytest.approx(
        {"core.rule": 4.0, "core.split": 2.0, UNLINKED: 1.0, OUTSIDE: 1.0})
    # rule: device 0's union (1, 4) = 30 %, device 1 none: 15 % over the two
    assert r["share_by_span"]["core.rule"] == pytest.approx(15.0)
    assert r["share_by_span"]["core.split"] == pytest.approx(10.0)
    # idle: device 0 (0, 1), (4, 6), (7, 10) = 6 s; device 1 (1, 7), (9, 10) = 7 s
    assert r["idle_share"] == pytest.approx(65.0)
    # issued: only device 1's (1, 7), whose split was launched at 6.6: 0.4 s
    assert r["idle_issued_share"] == pytest.approx(100 * 0.4 / 10 / 2)
