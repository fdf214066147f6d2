"""The port's GM rule on the CPU (the plain version of the CUDA kernel) vs
the JAX package's oracle and its Pallas kernel in interpret mode, over the
sweep of tests/test_kernels.py and at its bars; plus the exactness checks of
tests/test_genz_malik.py in the port."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import genz_malik as jgm
from repro.core import integrands as jint
from repro.core import rules as jrules
from repro.core.config import QuadratureConfig as JConfig
from repro.kernels import ops as jops
from repro_torch.core import genz_malik as tgm
from repro_torch.core import integrands as tint
from repro_torch.core import rules as trules
from repro_torch.core.config import QuadratureConfig as TConfig
from repro_torch.kernels import genz_malik_eval as tkernel
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import genz_malik_eval_soa_ref

torch.set_num_threads(1)


def _regions(rng, b, d, dtype=np.float64):
    centers = rng.uniform(0.1, 0.9, (b, d)).astype(dtype)
    halfw = rng.uniform(0.01, 0.1, (b, d)).astype(dtype)
    return centers, halfw


def _assert_rule_close(got, ref, rtol=1e-12):
    """The bars of tests/test_kernels.py: i7/i5/i3 at rtol, fourth
    differences at rtol 1e-8 with an absolute tolerance scaled to the
    largest one."""
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=rtol, atol=1e-300)
    dr = np.asarray(ref[3])
    np.testing.assert_allclose(
        np.asarray(got[3]), dr, rtol=1e-8, atol=float(np.max(np.abs(dr))) * 1e-10 + 1e-14
    )


def _port(entry, centers, halfw, theta=None, block_regions=0):
    return [
        t.numpy()
        for t in tops.genz_malik_eval(
            entry, torch.as_tensor(centers), torch.as_tensor(halfw), theta=theta,
            block_regions=block_regions,
        )
    ]


def _jax_oracle(fn, centers, halfw):
    return jgm.gm_eval_reference(fn, jnp.asarray(centers), jnp.asarray(halfw))


def _jax_kernel(fn, centers, halfw, theta=None, block_regions=0):
    return jops.genz_malik_eval(
        fn, jnp.asarray(centers), jnp.asarray(halfw), theta=theta,
        block_regions=block_regions, interpret=True,
    )


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("b", [64, 256])
def test_plain_version_matches_shapes(d, b):
    centers, halfw = _regions(np.random.default_rng(d * 100 + b), b, d)
    got = _port(tint.get("f4"), centers, halfw)
    _assert_rule_close(got, _jax_oracle(jint.get("f4").fn, centers, halfw))
    _assert_rule_close(got, _jax_kernel(jint.get("f4").fn, centers, halfw))


@pytest.mark.parametrize("name", ["f1", "f2", "f3", "f5", "f6", "f7"])
def test_plain_version_matches_integrands(name):
    centers, halfw = _regions(np.random.default_rng(7), 128, 4)
    got = _port(tint.get(name), centers, halfw)
    _assert_rule_close(got, _jax_oracle(jint.get(name).fn, centers, halfw))
    _assert_rule_close(got, _jax_kernel(jint.get(name).fn, centers, halfw))


@pytest.mark.parametrize("name", sorted(tint.PARAM_REGISTRY))
@pytest.mark.parametrize("d", [2, 3, 5])
def test_plain_version_matches_families(name, d):
    rng = np.random.default_rng(d * 10 + len(name))
    fam = jint.get_param(name)
    theta = fam.sample_theta(d, rng)
    centers, halfw = _regions(rng, 192, d)
    got = _port(tint.get_param(name), centers, halfw, theta=theta)
    _assert_rule_close(got, _jax_oracle(lambda x: fam.fn(x, theta), centers, halfw))
    _assert_rule_close(got, _jax_kernel(fam.fn, centers, halfw, theta=theta))


def test_plain_version_float32():
    centers, halfw = _regions(np.random.default_rng(3), 128, 3, np.float32)
    i7 = tops.genz_malik_eval(
        tint.get("f1"), torch.as_tensor(centers), torch.as_tensor(halfw)
    )[0]
    assert i7.dtype == torch.float32
    ref = _jax_oracle(
        jint.get("f1").fn, centers.astype(np.float64), halfw.astype(np.float64)
    )[0]
    np.testing.assert_allclose(i7.numpy(), np.asarray(ref), rtol=1e-3)
    jk = _jax_kernel(jint.get("f1").fn, centers, halfw)[0]
    np.testing.assert_allclose(i7.numpy(), np.asarray(jk), rtol=1e-3)


@pytest.mark.parametrize("block", [32, 64, 128, 512])
def test_plain_version_block_sizes(block):
    centers, halfw = _regions(np.random.default_rng(11), 192, 3)
    got = _port(tint.get("f3"), centers, halfw, block_regions=block)
    assert got[3].shape == (192, 3)
    _assert_rule_close(got, _jax_oracle(jint.get("f3").fn, centers, halfw))
    _assert_rule_close(
        got, _jax_kernel(jint.get("f3").fn, centers, halfw, block_regions=block)
    )


@pytest.mark.parametrize("name", ["f6", "genz_gaussian"])
def test_plain_version_d13(name):
    rng = np.random.default_rng(13)
    centers, halfw = _regions(rng, 8, 13)
    if name in tint.PARAM_REGISTRY:
        theta = jint.get_param(name).sample_theta(13, rng)
        got = _port(tint.get_param(name), centers, halfw, theta=theta)
        fn = lambda x: jint.get_param(name).fn(x, theta)  # noqa: E731
    else:
        got = _port(tint.get(name), centers, halfw)
        fn = jint.get(name).fn
    _assert_rule_close(got, _jax_oracle(fn, centers, halfw))


def test_soa_signature():
    centers, halfw = _regions(np.random.default_rng(1), 16, 3)
    ct, ht = torch.as_tensor(centers.T.copy()), torch.as_tensor(halfw.T.copy())
    i7, i5, i3, diffs = genz_malik_eval_soa_ref(tint.get("f2").fn, ct, ht)
    assert i7.shape == i5.shape == i3.shape == (16,) and diffs.shape == (3, 16)
    ref = _port(tint.get("f2"), centers, halfw)
    assert np.array_equal(i7.numpy(), ref[0]) and np.array_equal(diffs.numpy().T, ref[3])


@pytest.mark.parametrize("integrand", ["f4", "genz_gaussian:6,4,5:0.3,0.7,0.5"])
def test_rule_eval_batch_matches(integrand):
    d = 3
    centers, halfw = _regions(np.random.default_rng(21), 256, d)
    halfw[:16] = 0.05  # equal widths: ties in the widest-axis fallback
    jrule = jrules.make_rule(JConfig(d=d, integrand=integrand))
    trule = trules.make_rule(TConfig(d=d, integrand=integrand), device="cpu")
    je, jerr, jax_axis = jrule.eval_batch(jnp.asarray(centers), jnp.asarray(halfw))
    te, terr, tax = trule.eval_batch(torch.as_tensor(centers), torch.as_tensor(halfw))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-8)
    assert np.array_equal(tax.numpy(), np.asarray(jax_axis))
    assert trule.n_evals_per_region == jrule.n_evals_per_region


def test_make_rule_routes_and_refuses():
    rule = trules.make_rule(TConfig(d=2, integrand="genz_gaussian:5,5:0.3,0.7"))
    assert rule.integrand is tint.PARAM_REGISTRY["genz_gaussian"]
    assert np.array_equal(rule.theta["a"], [5.0, 5.0])
    assert trules.make_rule(TConfig(d=2)).integrand is tint.REGISTRY["f4"]

    def user_fn(x):
        return torch.exp(-(x * x).sum(0))

    cfg = TConfig(d=2)
    with pytest.raises(ValueError, match="REGISTRY"):
        trules.make_rule(cfg, user_fn, device=torch.device("cuda"))
    # on the CPU a callable runs through the plain version
    rule = trules.make_rule(cfg, user_fn, device=torch.device("cpu"))
    est, err, axis = rule.eval_batch(torch.full((4, 2), 0.5), torch.full((4, 2), 0.5))
    assert est.shape == (4,) and bool(torch.all(err >= 0))
    assert isinstance(trules.make_rule(TConfig(d=2, rule="gauss_kronrod")), trules.GaussKronrodRule)
    with pytest.raises(ValueError, match="prohibitive"):
        trules.make_rule(TConfig(d=7, rule="gauss_kronrod"))
    with pytest.raises(ValueError, match="theta requires"):
        trules.make_rule(cfg, theta={"a": np.ones(2)})


def test_kernel_wrapper_refuses_bad_inputs():
    c = torch.full((3, 8), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.genz_malik_eval_soa(3, c, c)
    with pytest.raises(ValueError, match="block_regions"):
        tops.genz_malik_eval(tint.get("f4"), c.T, c.T, block_regions=1024)
    with pytest.raises(ValueError, match="block_regions"):
        tops.genz_malik_eval(tint.get("f4"), c.T, c.T, block_regions=48)
    with pytest.raises(ValueError, match="unsupported device"):
        tops.genz_malik_eval(tint.get("f4"), c.T.to("meta"), c.T.to("meta"))


# --- exactness (the checks of tests/test_genz_malik.py, in the port) ---------------


def _random_poly(d, max_degree, seed):
    powers = [
        p
        for p in itertools.product(range(max_degree + 1), repeat=d)
        if sum(p) <= max_degree
    ]
    rng = np.random.default_rng(seed)
    coef = torch.as_tensor(rng.uniform(-1.0, 1.0, len(powers)))
    P = torch.as_tensor(np.array(powers, np.float64))  # (n_terms, d)

    def f(x):  # x: (d, N)
        return coef @ torch.prod(x[None, :, :] ** P[:, :, None], dim=1)

    def exact_box(center, halfw):
        val = 0.0
        for cf, p in zip(coef.tolist(), powers):
            term = cf
            for pi, c, h in zip(p, center, halfw):
                a, b = c - h, c + h
                term *= (b ** (pi + 1) - a ** (pi + 1)) / (pi + 1)
            val += term
        return val

    return f, exact_box


def _box(f, center, halfw):
    c = torch.tensor([center], dtype=torch.float64)
    h = torch.tensor([halfw], dtype=torch.float64)
    i7, i5, i3, diffs = tgm.gm_eval_reference(f, c, h)
    return float(i7[0]), float(i5[0]), float(i3[0]), diffs[0].numpy()


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6])
def test_degree7_exact(d):
    f, exact_box = _random_poly(d, 7, seed=d)
    center, halfw = [0.5] * d, [0.5] * d
    assert _box(f, center, halfw)[0] == pytest.approx(
        exact_box(center, halfw), rel=1e-11, abs=1e-12
    )


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_degree5_and_degree3_exact(d):
    center, halfw = [0.3] * d, [0.4] * d
    f5, exact5 = _random_poly(d, 5, seed=10 + d)
    assert _box(f5, center, halfw)[1] == pytest.approx(
        exact5(center, halfw), rel=1e-11, abs=1e-12
    )
    f3, exact3 = _random_poly(d, 3, seed=20 + d)
    assert _box(f3, center, halfw)[2] == pytest.approx(
        exact3(center, halfw), rel=1e-11, abs=1e-12
    )


def test_not_exact_beyond_degree():
    i7 = _box(lambda x: x[0] ** 8, [0.0], [1.0])[0]
    assert abs(i7 - 2.0 / 9.0) > 1e-6


def test_fourth_difference_picks_rough_axis():
    diffs = _box(lambda x: torch.cos(20.0 * x[1]) + 0.01 * x[0], [0.5] * 3, [0.5] * 3)[3]
    assert int(np.argmax(diffs)) == 1
