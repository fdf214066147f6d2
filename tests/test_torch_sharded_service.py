"""The port's multi-rank batch service on CPU ranks, against the JAX service.

``repro_torch.service.sharded_selftest`` runs the JAX package's sharded
service cases at 1, 2 and 4 ranks (and with the rebalancer off and the
advance unwindowed) and asserts that every result is the same in every run.
Here its summary is re-checked, and its results are held to the JAX
service's at one device on the same cases: equal status, iterations,
``n_evals``, ``admitted_at`` and ``finished_at``, the integral within rtol
1e-12 and the error within 1e-12 of |integral| (see
tests/test_torch_service.py).  The JAX package's own
tests/test_sharded_service.py shows that its results are the same at every
device count, so one device stands for them all.
"""

import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.core.integrands import get_param as jget_param
from repro.service import BatchScheduler as JScheduler
from repro.service import QuadRequest as JRequest
from repro_torch.core.integrands import get_param
from repro_torch.service import sharded_selftest

torch.set_num_threads(1)

CASES = ("converged_midflight", "evicted", "max_iters", "rebalanced")


@pytest.fixture(scope="module")
def port():
    return sharded_selftest.run(4, "cpu")


@pytest.fixture(scope="module")
def reference():
    family = jget_param("genz_gaussian")
    out = {}
    for name, (fields, make) in sharded_selftest.cases(get_param("genz_gaussian")).items():
        reqs = [JRequest(req_id=r.req_id, theta=r.theta, rel_tol=r.rel_tol) for r in make()]
        out[name] = JScheduler(JConfig(**fields), family).serve(reqs)
        out[name] = sorted(out[name], key=lambda r: r.req_id)
    return out


def test_parity_across_1_2_4_ranks(port):
    assert port["device_counts"] == [1, 2, 4]
    assert sorted(port["cases"]) == sorted(CASES)
    for name, case in port["cases"].items():
        assert case["parity"], name


def test_every_terminal_status_is_covered(port):
    cases = port["cases"]
    assert cases["converged_midflight"]["statuses"] == ["converged"]
    assert "capacity" in cases["evicted"]["statuses"]
    assert cases["max_iters"]["statuses"] == ["max_iters"]
    assert cases["converged_midflight"]["midflight_admissions"] > 0


def test_rebalanced_case_migrates(port):
    migrations = port["cases"]["rebalanced"]["migrations"]
    assert migrations[1] == 0
    assert migrations[2] > 0 and migrations[4] > 0


@pytest.mark.parametrize("name", CASES)
def test_matches_reference_service(port, reference, name):
    got = port["cases"][name]["results"]
    ref = reference[name]
    assert [t[0] for t in got] == [r.req_id for r in ref]
    for t, r in zip(got, ref):
        req_id, integral, error, status, iters, n_evals, admitted, finished = t
        assert (status, iters, n_evals, admitted, finished) == (
            r.status, r.iterations, r.n_evals, r.admitted_at, r.finished_at), (t, r)
        integral, error = float.fromhex(integral), float.fromhex(error)
        assert abs(integral - r.integral) <= 1e-12 * abs(r.integral), (t, r)
        assert abs(error - r.error) <= 1e-12 * abs(r.integral), (t, r)
