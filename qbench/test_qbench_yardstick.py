"""The idle-share union, the gap attribution and the roofline count on
synthetic timelines."""

import types

import pytest

from qbench import devtrace, files as families, readers, roofline


def test_union_counts_overlapping_streams_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.7)]
    assert devtrace.merge(iv) == [(0.0, 1.5), (2.0, 3.0)]
    assert devtrace.union_s(iv) == pytest.approx(2.5)
    assert sum(b - a for a, b in iv) == pytest.approx(3.2)  # a sum of self times counts 3.2


def test_idle_gaps_inside_the_window():
    iv = [(1.0, 2.0), (3.0, 4.0), (-1.0, 0.5)]
    assert devtrace.idle_gaps(iv, 0.0, 5.0) == [(0.5, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert devtrace.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_summarize_per_device_and_gaps_by_host_span():
    ops = {0: [("gm_eval_kernel<double>", 0.0, 1.0), ("sort", 1.0, 2.0), ("copy", 1.5, 2.5)],
           1: [("gm_eval_kernel<double>", 0.0, 0.5)]}
    spans = [(2.5, 4.0, 0, "qbench.solve"), (3.0, 4.0, 1, "core.advance")]
    t = devtrace.summarize(ops, (0.0, 4.0), [0, 1, 2], spans)
    d0, d1, d2 = (t["devices"][i] for i in (0, 1, 2))
    assert d0["busy_s"] == pytest.approx(2.5) and d0["ops"] == ops[0]
    assert (d1["busy_s"], d2["busy_s"]) == (0.5, 0.0)
    run = types.SimpleNamespace(trace=t, all_items=[dict(n_evals=401 * 2**20)],
                                config=dict(family="genz_gaussian",
                                            quadrature=dict(d=8, dtype="float64")))
    assert readers.kernel_s(run, "gm_eval_kernel") == pytest.approx(1.5)
    # every operation but the kernel, each device's union: 1.5, 0, 0 of 4 s
    assert readers.share_without(run, "gm_eval_kernel") == pytest.approx(100 * 1.5 / 4 / 3)
    assert readers.idle_share(run) == pytest.approx(100.0)
    least = roofline.gm_work(34, 8, 401 * 2**20)["least_s"]
    assert readers.gm_roofline(run, "gm_eval_kernel") == pytest.approx(100 * least / 1.5)
    assert readers.gm_roofline(run, "no such kernel") is None
    gaps = dict(t["idle_gaps"])
    # device 0 idles (2.5, 4.0) under core.advance; device 1 idles from 0.5
    # and device 2 throughout, both with their gaps' midpoints outside spans
    assert gaps == pytest.approx({"core.advance": 1.5, "outside host spans": 3.5 + 4.0})
    assert t["device_ops"][0][0] == "gm_eval_kernel<double>"


def test_roofline_count_of_the_8d_gaussian():
    d, regions = 8, 1 << 20
    assert roofline.n_nodes(d) == 401
    w = roofline.gm_work(families.load_code("families", "genz_gaussian").point_ops(d), d,
                         401 * regions)
    assert w["ops"] == pytest.approx(regions * (401 * 34 + 52))
    assert w["bytes"] == pytest.approx(regions * 27 * 8)
    assert w["bound_by"] == "operations"
    assert w["least_s"] == pytest.approx(regions * (401 * 34 + 52) / 34e12)
