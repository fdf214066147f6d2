"""The recorder and the Gauss-Kronrod service on the card.

With a recorder attached every driver gives the same bits, the same
``host_syncs`` and the same number of synchronising calls (counted by
``torch.cuda.set_sync_debug_mode("warn")``) as without one; and a GK fleet
on the card equals the port's ``integrate`` with GK on each theta, bit for
bit.  They need a CUDA device (and nvcc for the GM and sums kernels), and
skip without one.  They import neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_telemetry_gpu.py
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.adaptive import integrate, integrate_device
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.distributed import integrate_distributed
from repro_torch.core.integrands import get_param, to_spec
from repro_torch.mc import integrate_vegas
from repro_torch.service import BatchScheduler, QuadRequest
from repro_torch.service.sharded_selftest import tuples
from repro_torch.telemetry import MemorySink, Recorder

pytestmark = pytest.mark.gpu

FAMILY = get_param("genz_gaussian")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def warm():
    """Build and load the kernels before any count, so that both runs of a
    pair find them ready."""
    if torch.cuda.is_available():
        integrate(QuadratureConfig(d=2, integrand="f4", capacity=1 << 10), device="cuda")
        integrate_vegas(QuadratureConfig(d=2, integrand="f4", backend="vegas", rel_tol=1e-2),
                        device="cuda")


def _counted(fn):
    """``(fn(), synchronising calls)`` under the sync debug mode (its own
    one-time notice, on first use, is not a call)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def _bits(res):
    return (res.status, res.iterations, res.n_evals, res.integral.hex(), res.error.hex(),
            res.host_syncs)


def _on_off(run):
    off, n_off = _counted(lambda: run(None))
    rec = Recorder(sinks=(MemorySink(),))
    on, n_on = _counted(lambda: run(rec))
    assert n_on == n_off and n_off > 0
    return off, on, rec


DRIVERS = {
    "integrate": lambda cfg, dev, rec: integrate(cfg, device=dev, **rec),
    "integrate_device": lambda cfg, dev, rec: integrate_device(cfg, device=dev, **rec),
    "distributed": lambda cfg, dev, rec: integrate_distributed(cfg, devices=[dev] * 2, **rec),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_cubature_drivers_on_off(cuda, driver):
    cfg = QuadratureConfig(d=3, integrand="f4", rel_tol=1e-7, capacity=1 << 14)
    run = DRIVERS[driver]
    off, on, rec = _on_off(lambda r: run(cfg, cuda, {} if r is None else {"recorder": r}))
    assert _bits(on) == _bits(off)
    assert rec.span_totals


def test_vegas_on_off(cuda):
    cfg = QuadratureConfig(d=6, integrand="genz_gaussian:" + ",".join(["5"] * 6) + ":"
                           + ",".join(["0.5"] * 6), backend="vegas", rel_tol=1e-3,
                           mc_samples=1 << 16)
    off, on, rec = _on_off(
        lambda r: integrate_vegas(cfg, device=cuda, **({} if r is None else {"recorder": r})))
    assert _bits(on) + (on.chi2_dof,) == _bits(off) + (off.chi2_dof,)
    assert rec.span_totals["mc.iterate"]["count"] == off.iterations


@pytest.mark.parametrize("rule", ["genz_malik", "gauss_kronrod"])
def test_scheduler_on_off(cuda, rule):
    cfg = QuadratureConfig(d=3, integrand="genz_gaussian", rule=rule, rel_tol=1e-6,
                           capacity=1 << 11, batch_slots=4, sync_every=4)
    rng = np.random.default_rng(0)
    reqs = [QuadRequest(i, FAMILY.sample_theta(3, rng)) for i in range(8)]

    def run(rec):
        kw = {} if rec is None else {"recorder": rec}
        sched = BatchScheduler(cfg, FAMILY, devices=[cuda] * 2, **kw)
        return tuples(sched.serve(list(reqs))), sched.last_stats

    off, on, rec = _on_off(run)
    assert on == off
    assert rec.hists["service.dispatch_wall_s"]["count"] == rec.counters["service.dispatches"]


@pytest.mark.parametrize("ranks", [1, 2])
def test_gk_fleet_bit_equal_to_integrate_on_the_card(cuda, ranks):
    cfg = QuadratureConfig(d=3, integrand="genz_gaussian", rule="gauss_kronrod", rel_tol=1e-8,
                           capacity=1 << 12, batch_slots=4, sync_every=4)
    rng = np.random.default_rng(0)
    thetas = [FAMILY.sample_theta(3, rng) for _ in range(8)]
    results = sorted(BatchScheduler(cfg, FAMILY, devices=[cuda] * ranks).serve(
        [QuadRequest(i, t) for i, t in enumerate(thetas)]), key=lambda r: r.req_id)
    for res, theta in zip(results, thetas):
        single = integrate(
            QuadratureConfig(**dict(cfg.__dict__, integrand=to_spec(FAMILY, theta))), device=cuda)
        assert res.status == "converged"
        assert (res.status, res.iterations, res.n_evals, res.integral.hex(), res.error.hex()) == (
            single.status, single.iterations, single.n_evals, single.integral.hex(),
            single.error.hex()), (res, single)
