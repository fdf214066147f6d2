"""Graceful re-routing in the port, held to the JAX package's
``repro.service.routing`` on the same requests.

The counterparts of ``tests/test_faults.py``'s re-routing tests, with the
JAX ``GracefulScheduler`` run on the same config and requests in the same
process: the same primary statuses, the same provenance (``attempts``,
``retried_from``, ``backend``) for every request, and the re-routed
estimates within the reference test's bar (1e-2 of the exact value; the two
packages' VEGAS pools draw different samples, so their estimates agree only
statistically).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.service import BatchScheduler as JScheduler
from repro.service import GracefulScheduler as JGraceful
from repro.service import QuadRequest as JRequest
from repro.service import ReroutePolicy as JPolicy
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.service import (
    BatchScheduler,
    GracefulScheduler,
    QuadRequest,
    ReroutePolicy,
    serve,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = get_param("genz_gaussian")
CPU = ["cpu"]


def _fields(**kw):
    base = dict(d=2, integrand="genz_gaussian", rel_tol=1e-3, capacity=1 << 9,
                batch_slots=4, max_iters=60, sync_every=4)
    base.update(kw)
    return base


def _thetas(n, seed=0):
    rng = np.random.default_rng(seed)
    return [FAMILY.sample_theta(2, rng) for _ in range(n)]


def _pair(n, seed=0, **kw):
    """The same requests for both packages."""
    thetas = _thetas(n, seed)
    return ([QuadRequest(req_id=i, theta=t, **kw) for i, t in enumerate(thetas)],
            [JRequest(req_id=i, theta=t, **kw) for i, t in enumerate(thetas)])


def _provenance(results):
    return {r.req_id: (r.status if r.attempts == 1 else None, r.attempts, r.retried_from,
                       r.backend) for r in results}


# the capacity case of tests/test_faults.py: a 32-row store cannot reach 1e-7
CAPACITY = _fields(capacity=1 << 5, rel_tol=1e-7, mc_samples=4096, mc_max_iters=30)


def test_capacity_eviction_reroutes_to_vegas():
    reqs, jreqs = _pair(2)
    primary = {r.req_id: r.status for r in
               BatchScheduler(QuadratureConfig(**CAPACITY), FAMILY, devices=CPU).serve(reqs)}
    jprimary = {r.req_id: r.status for r in JScheduler(JConfig(**CAPACITY), "genz_gaussian")
                .serve(jreqs)}
    assert primary == jprimary and "capacity" in primary.values(), (primary, jprimary)

    graceful = GracefulScheduler(QuadratureConfig(**CAPACITY), FAMILY, devices=CPU)
    results = {r.req_id: r for r in graceful.serve(list(reqs))}
    jgraceful = JGraceful(JConfig(**CAPACITY), "genz_gaussian")
    jresults = {r.req_id: r for r in jgraceful.serve(list(jreqs))}
    assert _provenance(results.values()) == _provenance(jresults.values())
    rerouted = [r for r in results.values() if r.attempts == 2]
    assert rerouted, results
    for r in rerouted:
        assert r.retried_from == "capacity" and r.backend == "vegas"
        exact = FAMILY.exact(2, reqs[r.req_id].theta)
        assert abs(r.integral - exact) <= 1e-2 * abs(exact)
        assert abs(jresults[r.req_id].integral - exact) <= 1e-2 * abs(exact)
        assert "via=vegas" in r.summary()
    stats = graceful.last_stats
    assert stats["reroutes"] == len(rerouted) == jgraceful.last_stats["reroutes"]
    # the primary's and the VEGAS pool's counters, summed
    assert stats["admissions"] == len(reqs) + len(rerouted)
    assert stats["collections"] == len(reqs) + len(rerouted)


def test_reroute_respects_attempt_budget():
    fields = _fields(capacity=1 << 5, rel_tol=1e-7)
    reqs, jreqs = _pair(2)
    graceful = GracefulScheduler(QuadratureConfig(**fields), FAMILY, devices=CPU,
                                 policy=ReroutePolicy(max_attempts=1))
    results = list(graceful.serve(reqs))
    jresults = list(JGraceful(JConfig(**fields), "genz_gaussian",
                              policy=JPolicy(max_attempts=1)).serve(jreqs))
    assert _provenance(results) == _provenance(jresults)
    assert all(r.attempts == 1 for r in results)
    assert any(r.status == "capacity" for r in results)
    assert graceful.last_stats["reroutes"] == 0


def test_reroute_policy_validation():
    with pytest.raises(ValueError):
        ReroutePolicy(max_attempts=0).validate()
    with pytest.raises(ValueError):
        ReroutePolicy(tol_relax=0.5).validate()
    with pytest.raises(ValueError):
        GracefulScheduler(QuadratureConfig(**_fields()), FAMILY, devices=CPU,
                          policy=ReroutePolicy(tol_relax=0.5))


@pytest.mark.parametrize("backend", ["cubature", "vegas"])
def test_max_iters_retried_at_relaxed_tolerance(backend):
    """A request that ran out of iterations is retried once on its own
    backend with its tolerances loosened tenfold."""
    fields = _fields(backend=backend, rel_tol=1e-9, max_iters=3, batch_slots=2,
                     mc_samples=1024, mc_max_iters=8)
    reqs, jreqs = _pair(3)
    results = list(GracefulScheduler(QuadratureConfig(**fields), FAMILY, devices=CPU)
                   .serve(reqs))
    jresults = list(JGraceful(JConfig(**fields), "genz_gaussian").serve(jreqs))
    assert _provenance(results) == _provenance(jresults)
    assert all(r.attempts == 2 and r.retried_from == "max_iters" and r.backend == backend
               for r in results)


def test_serve_graceful_api_passes_clean_requests_through():
    """Requests that need no retry come back as the plain scheduler's, bit
    for bit."""
    reqs, _ = _pair(4, seed=3)
    cfg = QuadratureConfig(**_fields())
    plain = {r.req_id: r for r in serve(cfg, reqs, devices=CPU)}
    graceful = {r.req_id: r for r in serve(cfg, reqs, devices=CPU, graceful=True)}
    assert graceful == plain
    assert all(r.attempts == 1 and r.retried_from is None for r in graceful.values())


def test_serve_quad_cli_graceful():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_quad", "--device", "cpu",
         "--graceful", "--d", "2", "--capacity", "32", "--rel-tol", "1e-7",
         "--n-requests", "2", "--batch-slots", "2", "--mc-samples", "2048",
         "--mc-iters", "20", "--validate"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[")]
    assert len(lines) == 2 and any("via=vegas" in l for l in lines), proc.stdout
    assert "reroutes=" in proc.stdout
