"""The per-layer metric that reads the port's set-up spans, on synthetic timelines."""

import types

import pytest

from qbench import devtrace, harness


def _run(spans, n_items=2):
    ops = {0: [("gm_eval_kernel", 1.0, 2.0), ("sort", 4.0, 5.0)],
           1: [("gm_eval_kernel", 1.0, 2.0), ("sort", 4.5, 5.0)]}
    trace = devtrace.summarize(ops, (0.0, 6.0), [0, 1], spans)
    return types.SimpleNamespace(trace=trace, items=[{}] * n_items)


def test_init_idle_reads_the_gaps_under_the_set_up_spans():
    metric = harness.load_metric("init_idle_s.gauss8")
    # both cards idle (2, 4) and (2, 4.5) under the partition, inside
    # core.init; the gap (0, 1) falls under core.init itself, (5, 6) outside
    spans = [(0.0, 6.0, 0, "qbench.solve"), (0.0, 4.6, 1, "core.init"),
             (1.5, 4.6, 2, "core.partition")]
    run = _run(spans)
    gaps = dict(run.trace["idle_gaps"])
    assert gaps["core.partition"] == pytest.approx(2.0 + 2.5)
    assert gaps["core.init"] == pytest.approx(1.0 + 1.0)
    # (4.5 + 2) idle seconds over 2 cards and 2 integrals
    assert metric.read(run) == pytest.approx(6.5 / 2 / 2)
    # the distributed driver's set-up span counts too
    run = _run([(0.0, 6.0, 0, "qbench.solve"), (0.0, 4.6, 1, "dist.init")], n_items=1)
    assert metric.read(run) == pytest.approx((1.0 + 2.0 + 1.0 + 2.5) / 2)


def test_init_idle_reads_nothing_without_the_spans():
    metric = harness.load_metric("init_idle_s.gauss8")
    # a program whose only spans are the benchmark's and the JAX names
    assert metric.read(_run([(0.0, 6.0, 0, "qbench.solve"), (1.5, 4.6, 1, "core.eval")])) is None
    assert metric.read(types.SimpleNamespace(trace=None, items=[{}])) is None
