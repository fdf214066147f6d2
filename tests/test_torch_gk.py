"""The port's Gauss-Kronrod rule against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import gauss_kronrod as jgk
from repro.core import integrands as jint
from repro.core import rules as jrules
from repro.core.config import QuadratureConfig as JConfig
from repro_torch.core import adaptive as tad
from repro_torch.core import gauss_kronrod as tgk
from repro_torch.core import integrands as tint
from repro_torch.core import rules as trules
from repro_torch.core.config import QuadratureConfig as TConfig

torch.set_num_threads(1)


def test_nodes_and_weights_identical():
    for name in ("XK", "WK", "WG"):
        np.testing.assert_array_equal(getattr(tgk, name), getattr(jgk, name))
    assert tgk.N_1D == jgk.N_1D
    assert [tgk.n_nodes(d) for d in range(1, 7)] == [jgk.n_nodes(d) for d in range(1, 7)]


def _boxes(d, b, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 0.9, (b, d)), rng.uniform(0.01, 0.1, (b, d))


@pytest.mark.parametrize("name", ["f1", "f2", "f3", "f4", "f5", "f6", "f7"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_gk_eval_batch_matches_reference(name, d):
    c, h = _boxes(d, 37, 100 * d + int(name[1]))
    # chunk 512 leaves a ragged last chunk at every d (15^d is odd)
    ref = jgk.gk_eval_batch(jint.get(name).fn, jnp.asarray(c), jnp.asarray(h))
    got = tgk.gk_eval_batch(tint.get(name).fn, torch.as_tensor(c), torch.as_tensor(h))
    for g, r, label in zip(got[:2], ref[:2], ("i_k", "i_g")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-300, err_msg=label)
    disc = np.asarray(ref[2])
    # |K - G_i| cancels: an absolute floor scaled to the batch's estimates
    atol = 1e-13 * float(np.abs(np.asarray(ref[0])).max())
    np.testing.assert_allclose(got[2].numpy(), disc, rtol=1e-8, atol=atol)


@pytest.mark.parametrize("chunk", [1, 100, 4096])
def test_gk_eval_batch_chunking(chunk):
    c, h = _boxes(2, 5, 3)
    ref = jgk.gk_eval_batch(jint.get("f4").fn, jnp.asarray(c), jnp.asarray(h), chunk=chunk)
    got = tgk.gk_eval_batch(tint.get("f4").fn, torch.as_tensor(c), torch.as_tensor(h), chunk=chunk)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


@pytest.mark.parametrize("spec,d", [("f4", 2), ("f6", 3), ("genz_gaussian:5,5:0.3,0.7", 2)])
def test_rule_eval_batch_matches_reference(spec, d):
    c, h = _boxes(d, 64, 7)
    jrule = jrules.make_rule(JConfig(d=d, integrand=spec, rule="gauss_kronrod"))
    trule = trules.make_rule(TConfig(d=d, integrand=spec, rule="gauss_kronrod"))
    assert isinstance(trule, trules.GaussKronrodRule)
    assert trule.n_evals_per_region == jrule.n_evals_per_region == 15**d
    ref = jrule.eval_batch(jnp.asarray(c), jnp.asarray(h))
    got = trule.eval_batch(torch.as_tensor(c), torch.as_tensor(h))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-12)
    # err = |K - G| cancels to round-off: a floor scaled to the estimates
    atol = 1e-13 * float(np.abs(np.asarray(ref[0])).max())
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-8, atol=atol)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_rule_refuses_high_dimension():
    with pytest.raises(ValueError, match="prohibitive"):
        trules.make_rule(TConfig(d=7, rule="gauss_kronrod"))
    with pytest.raises(ValueError, match="prohibitive"):
        trules.GaussKronrodRule(8, tint.get("f4").fn)


# the cases of tests/test_eval_window.py (f1 d=2, f3 d=3), and three that
# refine several times
CASES = [
    ("f1", 2, 1e-8),
    ("f3", 3, 1e-7),
    ("f4", 2, 1e-8),
    ("f2", 2, 1e-8),
    ("f6", 2, 1e-5),
]


@pytest.mark.parametrize("name,d,rel_tol", CASES)
def test_integrate_matches_reference(name, d, rel_tol):
    kw = dict(d=d, integrand=name, rel_tol=rel_tol, capacity=1 << 13,
              rule="gauss_kronrod", max_iters=200)
    ref = jad.integrate(JConfig(**kw))
    got = tad.integrate(TConfig(**kw), device="cpu")
    assert got.status == ref.status == "converged", (got.summary(), ref.summary())
    assert (got.iterations, got.n_evals) == (ref.iterations, ref.n_evals)
    assert abs(got.integral - ref.integral) <= ref.error
    exact = jint.get(name).exact(d)
    assert abs(got.integral - exact) / abs(exact) <= 5 * rel_tol


def test_gk_runs_through_every_driver():
    cfg = TConfig(d=2, integrand="f4", rel_tol=1e-8, capacity=1 << 12, rule="gauss_kronrod")
    host = tad.integrate(cfg, device="cpu")
    dev = tad.integrate_device(cfg, device="cpu")
    assert (dev.integral, dev.error, dev.iterations, dev.n_evals) == (
        host.integral, host.error, host.iterations, host.n_evals
    )
    from repro_torch.core.distributed import integrate_distributed

    dist = integrate_distributed(cfg, devices=["cpu"] * 2)
    assert dist.status == "converged"
    assert abs(dist.integral - host.integral) <= 4 * cfg.rel_tol * abs(host.integral)


def test_gk_takes_a_user_callable_and_a_family():
    cfg = TConfig(d=2, rule="gauss_kronrod")

    def user_fn(x):
        return torch.exp(-(x * x).sum(0))

    rule = trules.make_rule(cfg, user_fn)
    assert rule.f is user_fn  # torch ops: no kernel id needed on any device
    fam = trules.make_rule(TConfig(d=2, integrand="genz_gaussian:5,5:0.3,0.7", rule="gauss_kronrod"))
    x = torch.rand(2, 9, dtype=torch.float64)
    family, theta = tint.parse_spec("genz_gaussian:5,5:0.3,0.7")
    assert torch.equal(fam.f(x), family.fn(x, theta))
