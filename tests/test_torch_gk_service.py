"""The Gauss-Kronrod rule in the port's batch service.

Every request of a GK fleet must be bit-equal to the port's own
``integrate`` with GK on its theta (status, iterations, evaluations,
integral and error to the bit), at 1, 2 and 4 CPU ranks; one region's GK
bits must not depend on the batch around it; and the fleet must match the
JAX ``integrate_batch`` with ``rule="gauss_kronrod"`` in status,
iterations and evaluations, with the integral within rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gauss_kronrod as gk
from repro_torch.core.adaptive import integrate
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param, to_spec
from repro_torch.core.rules import GaussKronrodRule, make_rule
from repro_torch.service import BatchScheduler, QuadRequest, integrate_batch
from repro_torch.service.batch_engine import estimate_state_bytes
from repro_torch.service.faults import nan_family, poison_theta
from repro_torch.service.sharded_selftest import tuples

torch.set_num_threads(1)

FAMILY = get_param("genz_gaussian")


def _thetas(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [FAMILY.sample_theta(d, rng) for _ in range(n)]


def _fleet_cfg(**kw):
    fields = dict(d=3, integrand="genz_gaussian", rule="gauss_kronrod", rel_tol=1e-8,
                  capacity=1 << 9, batch_slots=8, max_iters=40, sync_every=4)
    fields.update(kw)
    return QuadratureConfig(**fields)


def _single(cfg, theta, rel_tol=None):
    fields = dict(cfg.__dict__, integrand=to_spec(FAMILY, theta))
    if rel_tol is not None:
        fields["rel_tol"] = rel_tol
    return integrate(QuadratureConfig(**fields), device="cpu")


@pytest.fixture(scope="module")
def fleet():
    thetas = _thetas(8, 3)
    rel_tols = [1e-8 if i % 2 else 1e-5 for i in range(8)]
    requests = [QuadRequest(i, t, rel_tol=r) for i, (t, r) in enumerate(zip(thetas, rel_tols))]
    return thetas, rel_tols, requests


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_fleet_bit_equal_to_integrate(fleet, ranks):
    thetas, rel_tols, requests = fleet
    cfg = _fleet_cfg()
    sched = BatchScheduler(cfg, FAMILY, devices=["cpu"] * ranks)
    results = sorted(sched.serve(requests), key=lambda r: r.req_id)
    assert len(results) == len(requests)
    if ranks > 1:
        assert sched.last_stats["migrations"] > 0
    for res, theta, rel in zip(results, thetas, rel_tols):
        single = _single(cfg, theta, rel)
        assert res.status == "converged", res
        assert (res.status, res.iterations, res.n_evals, res.integral.hex(), res.error.hex()) == (
            single.status, single.iterations, single.n_evals, single.integral.hex(),
            single.error.hex()), (res, single)
        assert res.n_evals % 15**3 == 0


def test_advance_window_off_gives_the_same_bits(fleet):
    _, _, requests = fleet
    on = tuples(BatchScheduler(_fleet_cfg(), FAMILY, devices=["cpu"] * 2).serve(requests))
    off = tuples(BatchScheduler(_fleet_cfg(advance_window=False), FAMILY,
                                devices=["cpu"] * 2).serve(requests))
    assert on == off


def test_one_region_alone_and_in_a_batch_of_4096():
    """The same bits for a region evaluated alone and inside a 4096-region
    batch of 16 slots (theta by column), at the edges of the CPU's region
    blocks and of the slots."""
    d, b, slots = 3, 4096, 16
    rng = np.random.default_rng(5)
    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (b, d)))
    halfw = torch.as_tensor(rng.uniform(0.01, 0.1, (b, d)))
    thetas = _thetas(slots, d, seed=2)
    cols = torch.as_tensor(np.stack([np.concatenate([t["a"], t["u"]]) for t in thetas], axis=1))
    rule = make_rule(_fleet_cfg(), FAMILY)
    assert isinstance(rule, GaussKronrodRule) and rule.theta_fields == ("a", "u")
    batch = rule.eval_batch(centers, halfw, theta_cols=cols)
    raw = gk.gk_eval_batch(FAMILY.fn, centers, halfw, theta_cols=cols, theta_fields=("a", "u"))
    block = gk.region_block(torch.device("cpu"), d, 512)
    per_slot = b // slots
    for i in sorted({0, block - 1, block, per_slot - 1, per_slot, 1234, b - 1}):
        s = i // per_slot
        one = rule.eval_batch(centers[i:i + 1], halfw[i:i + 1], theta_cols=cols[:, s:s + 1])
        bound = make_rule(QuadratureConfig(d=d, rule="gauss_kronrod",
                                           integrand=to_spec(FAMILY, thetas[s])))
        alone = bound.eval_batch(centers[i:i + 1], halfw[i:i + 1])
        raw_one = gk.gk_eval_batch(lambda x: FAMILY.fn(x, thetas[s]), centers[i:i + 1],
                                   halfw[i:i + 1])
        for got, want in zip(batch, one):
            assert torch.equal(got[i:i + 1], want), i
        for got, want in zip(batch, alone):
            assert torch.equal(got[i:i + 1], want), i
        for got, want in zip(raw, raw_one):
            assert torch.equal(got[i:i + 1], want), i


def test_matches_the_jax_service():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core.config import QuadratureConfig as JConfig
    from repro.service import integrate_batch as jintegrate_batch

    fields = dict(d=2, integrand="genz_gaussian", rule="gauss_kronrod", rel_tol=1e-8,
                  capacity=1 << 9, batch_slots=4, max_iters=60)
    thetas = _thetas(3, 2)
    ref = jintegrate_batch(JConfig(**fields), thetas)
    got = integrate_batch(QuadratureConfig(**fields), thetas, devices=["cpu"])
    for r, g in zip(ref, got):
        assert r.status == "converged"
        assert (g.status, g.iterations, g.n_evals) == (r.status, r.iterations, r.n_evals), (g, r)
        np.testing.assert_allclose(g.integral, r.integral, rtol=1e-12)


def test_poisoned_request_ends_nonfinite_and_leaves_the_others_bits():
    thetas = _thetas(4, 2, seed=3)
    cfg = _fleet_cfg(d=2)
    clean = {r.req_id: r for r in BatchScheduler(cfg, FAMILY, devices=["cpu"]).serve(
        [QuadRequest(i, t) for i, t in enumerate(thetas)])}
    reqs = [QuadRequest(i, t) for i, t in enumerate(thetas)]
    reqs.insert(2, QuadRequest(9, poison_theta(thetas[1])))
    got = {r.req_id: r for r in BatchScheduler(cfg, nan_family(FAMILY), devices=["cpu"]).serve(reqs)}
    assert got.pop(9).status == "nonfinite"
    assert got == clean


def test_state_bytes_count_the_gk_transient():
    gm = estimate_state_bytes(_fleet_cfg(rule="genz_malik"))
    gkb = estimate_state_bytes(_fleet_cfg())
    assert gkb - gm == gk.transient_bytes(3, 8 * (1 << 9), 8)
    big = QuadratureConfig(d=3, integrand="genz_gaussian", rule="gauss_kronrod",
                           capacity=1 << 14, batch_slots=16)
    # the transient is bounded by the card's block, whatever the fleet
    assert gk.transient_bytes(3, 16 << 14, 8) < 2 << 30
    assert estimate_state_bytes(big) < 2 << 30
