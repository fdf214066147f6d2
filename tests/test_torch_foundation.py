"""Port foundation vs the JAX package: constants, integrands, error model,
axis choice, config validation; plus the port's import isolation and its
refusal to fall back to the CPU silently."""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jcfg
from repro.core import error as jerror
from repro.core import genz_malik as jgm
from repro.core import integrands as jint
from repro.core import rules as jrules
from repro_torch.core import adaptive as tadaptive
from repro_torch.core import config as tcfg
from repro_torch.core import error as terror
from repro_torch.core import genz_malik as tgm
from repro_torch.core import integrands as tint
from repro_torch.core import rules as trules

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def port_config(cfg: jcfg.QuadratureConfig) -> tcfg.QuadratureConfig:
    fields = dataclasses.asdict(cfg)
    fields.pop("use_kernel")
    fields.pop("interpret")
    return tcfg.QuadratureConfig(**fields)


# --- constants -----------------------------------------------------------------


@pytest.mark.parametrize("d", range(1, 14))
def test_gm_weights_bit_identical(d):
    assert dataclasses.astuple(tgm.gm_weights(d)) == dataclasses.astuple(
        jgm.gm_weights(d)
    )
    assert tgm.n_nodes(d) == jgm.n_nodes(d)


def test_rule_constants_identical():
    for name in ("LAMBDA2", "LAMBDA3", "LAMBDA4", "LAMBDA5", "FOURTH_DIFF_RATIO"):
        assert getattr(tgm, name) == getattr(jgm, name), name


# --- integrands ------------------------------------------------------------------


# XLA on the CPU flushes subnormal results to zero, PyTorch keeps them: the
# absolute tolerance is the smallest normal float64 and covers only that.
TINY = np.finfo(np.float64).tiny


def _points(d, n, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (d, n))


@pytest.mark.parametrize("d", [1, 3, 8, 13])
@pytest.mark.parametrize("name", sorted(tint.REGISTRY))
def test_fixed_integrands_match(name, d):
    x = _points(d, 512, seed=d)
    ref = np.asarray(jint.get(name).fn(jnp.asarray(x)))
    got = tint.get(name).fn(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=TINY)


@pytest.mark.parametrize("d", [1, 2, 5, 13])
@pytest.mark.parametrize("name", sorted(tint.PARAM_REGISTRY))
def test_families_match(name, d):
    x = _points(d, 512, seed=100 + d)
    theta = jint.PARAM_REGISTRY[name].sample_theta(d, np.random.default_rng(d))
    ref = np.asarray(jint.PARAM_REGISTRY[name].fn(jnp.asarray(x), theta))
    got = tint.PARAM_REGISTRY[name].fn(torch.as_tensor(x), theta).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=TINY)
    assert tint.PARAM_REGISTRY[name].exact(d, theta) == jint.PARAM_REGISTRY[
        name
    ].exact(d, theta)


def test_sample_theta_identical():
    for name, fam in tint.PARAM_REGISTRY.items():
        a = fam.sample_theta(4, np.random.default_rng(3))
        b = jint.PARAM_REGISTRY[name].sample_theta(4, np.random.default_rng(3))
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k])
        assert fam.theta_fields == jint.PARAM_REGISTRY[name].theta_fields


@pytest.mark.parametrize("name", sorted(tint.REGISTRY))
def test_exact_values_identical(name):
    for d in range(1, 11):
        assert tint.get(name).exact(d) == jint.get(name).exact(d)


def test_spec_parsing_matches():
    spec = "genz_gaussian:6,4:0.3,0.7"
    fam, theta = tint.parse_spec(spec)
    jfam, jtheta = jint.parse_spec(spec)
    assert fam.name == jfam.name
    for k in theta:
        assert np.array_equal(theta[k], jtheta[k])
    assert tint.get(spec).exact(2) == jint.get(spec).exact(2)
    assert tint.get(spec).name == jint.get(spec).name
    for bad in ("genz_gaussian", "genz_gaussian:1,2", "genz_gaussian:1,2:3",
                "genz_gaussian:a:b", "nope:1"):
        with pytest.raises((ValueError, KeyError)):
            jint.get(bad) if bad.startswith("nope") else jint.parse_spec(bad)
        with pytest.raises((ValueError, KeyError)):
            tint.get(bad) if bad.startswith("nope") else tint.parse_spec(bad)


def test_theta_length_check():
    x = torch.as_tensor(_points(3, 8, 0))
    with pytest.raises(ValueError, match="theta leaf"):
        tint.PARAM_REGISTRY["monomial"].fn(x, {"p": np.ones(2)})
    with pytest.raises(ValueError, match="d=3"):
        tint.bind(tint.PARAM_REGISTRY["monomial"], {"p": np.ones(2)}).exact(3)


def test_kernel_ids_are_distinct():
    ids = [e.kernel_id for e in tint.REGISTRY.values()] + [
        f.kernel_id for f in tint.PARAM_REGISTRY.values()
    ]
    assert sorted(ids) == list(range(10))


# --- error model and axis choice ------------------------------------------------


def _error_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    i7 = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 3, n)
    i5 = i7 + rng.standard_normal(n) * 10.0 ** rng.integers(-16, -2, n)
    i3 = i5 + rng.standard_normal(n) * 10.0 ** rng.integers(-16, 0, n)
    # exact ties: n1 == 0, n2 == 0, both zero
    i5[:64] = i7[:64]
    i3[64:128] = i5[64:128]
    i5[128:160] = i3[128:160] = i7[128:160]
    vol = 10.0 ** rng.uniform(-12, 0, n)
    maxdiff = np.abs(i7) / vol * 10.0 ** rng.uniform(-4, 1, n)
    return i7, i5, i3, vol, maxdiff


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_level_error_matches(seed):
    args = _error_inputs(seed)
    ref = np.asarray(jerror.two_level_error(*map(jnp.asarray, args), 50.0))
    got = terror.two_level_error(*map(torch.as_tensor, args), 50.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)


def test_select_axis_matches_with_ties_and_flat_rows():
    rng = np.random.default_rng(5)
    n, d = 512, 6
    diffs = rng.uniform(0.0, 1.0, (n, d))
    halfw = rng.uniform(0.01, 0.1, (n, d))
    diffs[:100, 3] = diffs[:100, 1] = 2.0  # tied maxima: first one wins
    halfw[100:200, 4] = halfw[100:200, 2] = 0.5
    diffs[100:200] = 1e-15  # flat rows (<= 100 eps): widest axis, tied
    diffs[200:220] = 100 * np.finfo(np.float64).eps  # exactly at the bar
    ref = np.asarray(jrules._select_axis(jnp.asarray(diffs), jnp.asarray(halfw)))
    got = trules._select_axis(torch.as_tensor(diffs), torch.as_tensor(halfw)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    assert np.all(got[:100] == 1) and np.all(got[100:200] == 2)


# --- config ----------------------------------------------------------------------


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.QuadratureConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.QuadratureConfig)}
    assert set(jf) - set(tf) == {"use_kernel", "interpret"}
    assert set(tf) <= set(jf)
    for k in tf:
        assert tf[k] == jf[k], k


BAD_CONFIGS = [
    dict(d=0),
    dict(d=3, capacity=1000),
    dict(d=3, n_init=3),
    dict(d=3, capacity=16, n_init=16),
    dict(d=3, classifier="greedy"),
    dict(d=3, rule="simpson"),
    dict(d=3, eval_window_min=3),
    dict(d=3, block_regions=48),
    dict(d=3, sync_every=0),
    dict(d=3, batch_slots=0),
    dict(d=3, backend="quantum"),
    dict(d=3, mc_samples=100, mc_shards=8),
    dict(d=3, mc_warmup=0),
    dict(d=3, mc_max_iters=5),
    dict(d=3, domain_lo=(0.0, 0.0)),
    dict(d=3, rebalance="xor"),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_validate_rejects_the_same_configs(kw):
    with pytest.raises(ValueError):
        jcfg.QuadratureConfig(**kw).validate()
    with pytest.raises(ValueError):
        tcfg.QuadratureConfig(**kw).validate()


def test_port_config_from_reference():
    cfg = jcfg.QuadratureConfig(d=4, integrand="f2", rel_tol=1e-5, capacity=1 << 10)
    p = port_config(cfg).validate()
    assert (p.d, p.integrand, p.rel_tol, p.capacity) == (4, "f2", 1e-5, 1 << 10)
    assert p.resolved_n_init() == cfg.resolved_n_init()


# --- isolation and device ---------------------------------------------------------


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_integrate_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.QuadratureConfig(d=2, capacity=1 << 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tadaptive.integrate(cfg)
    assert tadaptive.integrate(cfg, device="cpu").status == "converged"


def test_cli_without_device_raises_when_cuda_absent(monkeypatch):
    from repro_torch.launch import integrate as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--d", "2", "--capacity", "256"])
