"""A run with the timed path broken underneath comes out not correct.

Each cell runs on the CPU at a small size (``qbench/small.py``: the same
drivers, entries and comparison, the cell's own limits), once as it is and
once with each fault that the cell can have planted in the port: a step
that returns its state unchanged, half of the batch left out with the mean
taken over the rest, the exchange between ranks left out (four-rank cells),
and an answer altered where it is produced (the rule's estimates).
"""

import time

import pytest
import torch

from qbench import files, harness, reference
from qbench.small import small

from repro_torch.core import adaptive, distributed, ranks
from repro_torch.service import batch_engine

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
RULE_USERS = (adaptive, distributed, batch_engine)


def _wrap_rule(monkeypatch, transform):
    for mod in RULE_USERS:
        make = mod.make_rule

        def faulty(*a, _make=make, **k):
            rule = _make(*a, **k)
            inner = rule.eval_batch

            def eval_batch(*x, **y):
                return transform(*inner(*x, **y))

            rule.eval_batch = eval_batch
            return rule

        monkeypatch.setattr(mod, "make_rule", faulty)


def unchanged(monkeypatch):
    monkeypatch.setattr(adaptive, "classify_split_compact", lambda state, fin, window=None: state)
    monkeypatch.setattr(distributed, "classify_split_compact",
                        lambda state, fin, window=None: state)
    monkeypatch.setattr(batch_engine, "split_compact_rows",
                        lambda capacity, rows, scalars, fin: (rows, scalars))


def half_batch(monkeypatch):
    def transform(est, err, axis):
        h = est.shape[0] // 2
        est, err = est.clone(), err.clone()
        est[h:] = est[:h].mean() if h else est[h:]
        err[h:] = err[:h].mean() if h else err[h:]
        return est, err, axis

    _wrap_rule(monkeypatch, transform)


def no_exchange(monkeypatch):
    monkeypatch.setattr(ranks.Ranks, "psum",
                        lambda self, tensors: tensors[0].to(self.first, non_blocking=True))


def altered(monkeypatch):
    _wrap_rule(monkeypatch, lambda est, err, axis: (est * (1.0 + 1e-3), err, axis))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
          "no_exchange": no_exchange}


def _run(cell, seconds):
    config, traffic, devices = small(cell)
    return harness.run_cell(cell, 20240611, seconds, False, devices, time.monotonic(), config,
                           traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line, _ = _run(cell, 0.3)
    assert line["correct"], (line["checks"], line["metrics"], line["attempted"])
    assert len(line["item_s"]) == line["attempted"]


# the request-stream driver, which no cell uses yet: a sweep of drawn 3-D
# Gaussians through the batch service, judged by the same comparison
SWEEP_CONFIG = {"family": "genz_gaussian", "theta": {"a": [5.0] * 3, "u": [0.5] * 3},
                "quadrature": {"d": 3, "rel_tol": 1e-7, "capacity": 1 << 12, "batch_slots": 4,
                               "max_iters": 60, "rule": "genz_malik", "dtype": "float64"}}
SWEEP_TRAFFIC = {"kind": "request_stream", "pool": 16, "pool_seed": 0,
                 "theta": {"a": [3.0, 10.0], "u": [0.2, 0.8]}, "rel_tol": [1e-3, 1e-7],
                 "warmup": 4, "quadrature": {"admit_every": 1, "sync_every": 4}}
SWEEP_LIMITS = {"failed_share": 0.2, "worst_err_over_tol": 1000.0}


@pytest.mark.parametrize("fault", [None, "altered"])
def test_request_stream_driver(monkeypatch, fault):
    if fault:
        FAULTS[fault](monkeypatch)
    out = files.load_code("drivers", "request_stream").run(
        SWEEP_CONFIG, SWEEP_TRAFFIC, 11, 2.0, ["cpu"], False)
    answers = [dict(i, exact=reference.exact(i["family"], i["d"], i["theta"]))
               for i in out.items]
    assert out.in_window and {"requests_per_s", "request_p95_s"} <= set(out.e2e)
    assert reference.passes(reference.judge(answers, SWEEP_LIMITS)) == (fault is None)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if f != "no_exchange" or harness.load_json(
        harness.HERE / "configs" / f"{harness.cell_entry(harness.manifest(), c)['config']}.json"
    ).get("ranks", 1) > 1])
def test_fault_is_caught(monkeypatch, cell, fault):
    torch.manual_seed(0)
    FAULTS[fault](monkeypatch)
    line, out = _run(cell, 0.3)
    # the comparison itself fails, on answers the run did produce
    assert out.items and not reference.passes(line["checks"]), line["checks"]
    assert not line["correct"]
