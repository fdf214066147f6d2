"""The port's VEGAS backend on the CPU, held to the JAX package's ``repro.mc``.

The reference draws its uniforms with ``jax.random`` and the port with
``torch.Generator``s, so the two are compared in two ways:

- the deterministic stages on the same inputs, made with numpy from a seed:
  the grid (``apply_map``, ``refine``: rtol 1e-13), the stratification
  (``choose_n_strat``, ``cube_digits``, ``allocate_counts``, ``sample_y``:
  equal; ``adapt_weights``: rtol 1e-14), one iteration from the same state
  with the reference's own uniforms fed to the port through ``make_iterate``'s
  ``uniforms`` argument (counts equal; grid, weights, sums and estimates
  within rtol 1e-12, the error and chi^2/dof within 1e-9), and whole runs with the reference's uniforms on the cases of
  ``tests/test_mc.py`` (the same status, iterations and evaluations; the
  integral within rtol 1e-12 and the error within rtol 1e-9).  The
  tolerances cover the integrands' last-bit differences between XLA and
  PyTorch (ROADMAP, "Known differences"), which chi^2, a difference of
  accumulators, magnifies relative to its own size;
- with the port's own generator, the statistical bars of ``tests/test_mc.py``
  (the exact value within 5 reported errors, the chi^2 guard) and its
  determinism, on one rank and over CPU ranks (bit-equal), and through the
  service pool.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.mc import engine as jengine
from repro.mc import grid as jgrid
from repro.mc import stratified as jstrat
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import PARAM_REGISTRY, get as get_integrand, get_param
from repro_torch.kernels import vegas_sums as vsums
from repro_torch.launch.gm_perf import sums_hard_case
from repro_torch.mc import engine, grid, stratified
from repro_torch.mc.multi_device import integrate_vegas_distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["cpu"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


# --- grid ---------------------------------------------------------------------


def _edges(d, nb, rng):
    """A non-uniform grid: sorted interior edges between 0 and 1."""
    inner = np.sort(rng.uniform(0.0, 1.0, (d, nb - 1)), axis=1)
    return np.concatenate([np.zeros((d, 1)), inner, np.ones((d, 1))], axis=1)


def test_uniform_edges_equal():
    for d, nb in [(1, 2), (3, 16), (5, 64), (2, 50)]:
        np.testing.assert_array_equal(
            grid.uniform_edges(d, nb, device="cpu").numpy(), np.asarray(jgrid.uniform_edges(d, nb))
        )


@pytest.mark.parametrize("d,nb", [(1, 8), (3, 16), (6, 64)])
def test_apply_map_matches(d, nb):
    rng = np.random.default_rng(d * 100 + nb)
    edges = _edges(d, nb, rng)
    y = rng.uniform(0.0, 1.0, (d, 777))
    y[0, :3] = [0.0, 1.0 - 2**-52, 0.5]
    x01, jac = grid.apply_map(_t(edges), _t(y))
    rx, rjac = jgrid.apply_map(jnp.asarray(edges), jnp.asarray(y))
    _close(x01, rx, 1e-13, "x01")
    _close(jac, rjac, 1e-13, "jac")
    np.testing.assert_array_equal(
        grid.bin_index(_t(y) * nb, nb).numpy(), np.asarray(jgrid.bin_index(jnp.asarray(y), nb))
    )


@pytest.mark.parametrize("kind", ["random", "zero_axis", "spiky", "nonfinite_axis"])
def test_refine_matches(kind):
    d, nb = 4, 32
    rng = np.random.default_rng(7)
    edges = _edges(d, nb, rng)
    dsum = rng.uniform(0.0, 1.0, (d, nb)) ** 4
    if kind == "zero_axis":
        dsum[1] = 0.0
    elif kind == "spiky":
        dsum[:] = 1e-12
        dsum[2, 5] = 1e6
    elif kind == "nonfinite_axis":
        dsum[3, 2] = np.inf
    got = grid.refine(_t(edges), _t(dsum), 0.75)
    want = jgrid.refine(jnp.asarray(edges), jnp.asarray(dsum), 0.75)
    _close(got, want, 1e-13)
    if kind == "zero_axis":
        np.testing.assert_array_equal(got[1].numpy(), edges[1])


def test_refine_batched_equals_per_problem():
    rng = np.random.default_rng(3)
    edges = np.stack([_edges(3, 16, rng) for _ in range(4)])
    dsum = rng.uniform(0.0, 1.0, (4, 3, 16))
    dsum[2, 1] = 0.0
    got = grid.refine(_t(edges), _t(dsum), 0.5)
    for p in range(4):
        np.testing.assert_array_equal(
            got[p].numpy(), grid.refine(_t(edges[p]), _t(dsum[p]), 0.5).numpy()
        )


# --- stratification -----------------------------------------------------------


def test_choose_n_strat_equal():
    for d in (1, 2, 3, 5, 9, 10, 15):
        for n, n_min in [(512, 4), (8192, 4), (1 << 18, 4), (1 << 22, 4), (4096, 2)]:
            assert stratified.choose_n_strat(d, n, n_min) == jstrat.choose_n_strat(d, n, n_min)


def test_cube_digits_equal():
    for n_strat, d in [(3, 4), (2, 10), (1, 5), (5, 2)]:
        cube = np.arange(n_strat**d, dtype=np.int64)
        got = stratified.cube_digits(_t(cube), n_strat, d)
        want = jstrat.cube_digits(jnp.asarray(cube, jnp.int32), n_strat, d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weights", ["uniform", "zero", "spiky", "random"])
def test_allocate_counts_equal(weights):
    m, n, n_min = 64, 4096, 4
    rng = np.random.default_rng(11)
    w = {
        "uniform": np.ones(m),
        "zero": np.zeros(m),
        "spiky": np.eye(1, m, 7)[0] * 1e6,
        "random": rng.uniform(0.0, 1.0, m) ** 3,
    }[weights]
    got = stratified.allocate_counts(_t(w), n, n_min)
    want = np.asarray(jstrat.allocate_counts(jnp.asarray(w), n, n_min))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == n and int(got.min()) >= n_min
    # the batched form gives each row its own counts
    both = stratified.allocate_counts(_t(np.stack([w, np.ones(m)])), n, n_min)
    np.testing.assert_array_equal(both[0].numpy(), want)


def test_sample_y_equal(monkeypatch):
    rng = np.random.default_rng(5)
    d, n_strat, n_min, n = 3, 4, 4, 4096
    m = n_strat**d
    counts = np.asarray(jstrat.allocate_counts(jnp.asarray(rng.uniform(size=m)), n, n_min))
    index = np.arange(1024, 2048)
    u = rng.uniform(0.0, 1.0, (d, index.size))
    u[0, 0] = 1.0  # clipped to 1 - eps by both
    y, cube = stratified.sample_y(
        _t(u), torch.cumsum(_t(counts.astype(np.int64)), 0), _t(index), n_strat, d
    )
    # the reference draws u from its key: hand it ours instead
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype: jnp.asarray(u, dtype))
    ry, rcube = jstrat.sample_y(None, jnp.asarray(counts), jnp.asarray(index), n_strat, d,
                                jnp.float64)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(cube.numpy(), np.asarray(rcube))


def test_adapt_weights_match():
    rng = np.random.default_rng(9)
    old = rng.dirichlet(np.ones(81))
    var = rng.uniform(-0.1, 2.0, 81) ** 3
    for beta in (0.0, 0.75, 1.0):
        _close(stratified.adapt_weights(_t(old), _t(var), beta),
               jstrat.adapt_weights(jnp.asarray(old), jnp.asarray(var), beta), 1e-14)
    zero = stratified.adapt_weights(_t(old), torch.zeros(81, dtype=torch.float64), 0.75)
    _close(zero, 0.5 * old + 0.5 / 81, 1e-15)


# --- the sums: kernel's plain version against the reference's segment sums ----


def test_sums_match_segment_sums():
    """The plain version of the sums kernel (the CPU path) against
    ``jax.ops.segment_sum`` on the same values, shard by shard: equal, since
    both add in sample order."""
    rng = np.random.default_rng(2)
    d, nb, m, n_shards, ns = 3, 8, 27, 4, 256
    n = n_shards * ns
    counts = np.asarray(jstrat.allocate_counts(jnp.asarray(rng.uniform(size=m) ** 2), n, 4))
    cum = np.cumsum(counts.astype(np.int64))
    w = rng.normal(size=(1, n)) * np.exp(rng.normal(size=(1, n)))
    y = rng.uniform(0.0, 1.0, (d, 1, n))
    for first, k in [(0, 4), (1, 2), (3, 1)]:
        sl = slice(first * ns, (first + k) * ns)
        s1, s2, g = vsums.vegas_sums(
            _t(w[:, sl]).contiguous(), _t(y[:, :, sl]).contiguous(), _t(cum[None]), nb, first, ns
        )
        for j in range(k):
            shard = first + j
            idx = np.arange(shard * ns, (shard + 1) * ns)
            cube = np.searchsorted(cum, idx, side="right")
            ws = jnp.asarray(w[0, idx])
            np.testing.assert_array_equal(s1[0, j].numpy(), jax.ops.segment_sum(ws, cube, m))
            np.testing.assert_array_equal(s2[0, j].numpy(), jax.ops.segment_sum(ws * ws, cube, m))
            b = np.asarray(jgrid.bin_index(jnp.asarray(y[:, 0, idx]), nb))
            flat = (np.arange(d)[:, None] * nb + b).reshape(-1)
            want = jax.ops.segment_sum(jnp.broadcast_to(ws * ws, (d, ns)).reshape(-1), flat,
                                       d * nb)
            np.testing.assert_array_equal(g[0, j].numpy().reshape(-1), np.asarray(want))


def test_sums_chunked_order():
    """Shards longer than one chunk: the plain version (the kernel's
    arithmetic) against its definition, written as Python loops: each
    chunk's pieces and bins summed in sample order, then the chunk partials
    in chunk order; and against the reference's sample-order segment sums
    within 1e-14."""
    rng = np.random.default_rng(4)
    d, nb, m, n_shards, ns = 2, 4, 9, 3, vsums.CHUNK * 2 + 452
    n = n_shards * ns
    weights = np.ones(m)
    weights[4] = 400.0  # one cube spans chunks and shards
    counts = np.asarray(jstrat.allocate_counts(jnp.asarray(weights), n, 4)).astype(np.int64)
    cum = np.cumsum(counts)
    w = rng.normal(size=(1, n))
    y = rng.uniform(0.0, 1.0, (d, 1, n))
    s1, s2, g = vsums.vegas_sums(_t(w), _t(y), _t(cum[None]), nb, 0, ns)
    cube = np.searchsorted(cum, np.arange(n), side="right")
    bins = np.clip((y[:, 0] * nb).astype(np.int64), 0, nb - 1)
    for shard in range(n_shards):
        want1, want2, wantg = np.zeros(m), np.zeros(m), np.zeros((d, nb))
        for c0 in range(0, ns, vsums.CHUNK):
            p1, p2, pg = np.zeros(m), np.zeros(m), np.zeros((d, nb))
            for j in range(shard * ns + c0, shard * ns + min(c0 + vsums.CHUNK, ns)):
                v = w[0, j]
                p1[cube[j]] += v
                p2[cube[j]] += v * v
                for i in range(d):
                    pg[i, bins[i, j]] += v * v
            want1 += p1
            want2 += p2
            wantg += pg
        np.testing.assert_array_equal(s1[0, shard].numpy(), want1)
        np.testing.assert_array_equal(s2[0, shard].numpy(), want2)
        np.testing.assert_array_equal(g[0, shard].numpy(), wantg)
        idx = np.arange(shard * ns, (shard + 1) * ns)
        ws = jnp.asarray(w[0, idx])
        _close(s2[0, shard], jax.ops.segment_sum(ws * ws, cube[idx], m), 1e-14)


def _sums_by_definition(w, y, cum, nb, shard0, ns):
    """The sums' order written as Python loops: in each chunk, each cube
    piece and each (axis, bin) summed in sample order from +0, then the
    chunk partials in chunk order from +0; a NaN coordinate falls in bin 0."""
    (P, n), d, m = w.shape, y.shape[0], cum.shape[1]
    shards = n // ns
    s1, s2, g = np.zeros((P, shards, m)), np.zeros((P, shards, m)), np.zeros((P, shards, d, nb))
    for p in range(P):
        cube = np.searchsorted(cum[p], shard0 * ns + np.arange(n), side="right")
        for shard in range(shards):
            for c0 in range(0, ns, vsums.CHUNK):
                p1, p2, pg = np.zeros(m), np.zeros(m), np.zeros((d, nb))
                for j in range(shard * ns + c0, shard * ns + min(c0 + vsums.CHUNK, ns)):
                    v = float(w[p, j])
                    p1[cube[j]] += v
                    p2[cube[j]] += v * v
                    for i in range(d):
                        t = float(y[i, p, j]) * nb
                        pg[i, 0 if t != t else min(max(int(t), 0), nb - 1)] += v * v
                s1[p, shard] += p1
                s2[p, shard] += p2
                g[p, shard] += pg
    return s1, s2, g


@pytest.mark.parametrize("case", ["one_bin", "y_edges", "nb2", "nb300", "w_nonfinite", "odd_ns"])
def test_sums_hard_cases_by_definition(case):
    """The plain version (the kernel's contract, bit for bit) against the
    order's definition on the kernel's hard inputs: every sample of an axis
    in one bin and one cube, y at 0, -0, 1, below 0, above 1 and NaN, bin
    counts 2 and 300, NaN, +-inf and -0.0 in w, short last chunks and odd
    shards."""
    w, y, cum, nb, shard0, ns = sums_hard_case(case, "cpu")
    assert w.dtype == torch.float64
    got = vsums.vegas_sums(w, y, cum, nb, shard0, ns)
    for a, want in zip(got, _sums_by_definition(w.numpy(), y.numpy(), cum.numpy(), nb, shard0, ns)):
        np.testing.assert_array_equal(a.numpy(), want)


def test_sums_reject_bad_shapes():
    w = torch.zeros(1, 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="whole shards"):
        vsums.vegas_sums(w, torch.zeros(2, 1, 10, dtype=torch.float64),
                         torch.ones(1, 3, dtype=torch.int64), 4, 0, 4)
    with pytest.raises(TypeError, match="int64"):
        vsums.vegas_sums(w, torch.zeros(2, 1, 10, dtype=torch.float64),
                         torch.ones(1, 3, dtype=torch.int32), 4, 0, 5)


# --- one iteration and whole runs with the reference's uniforms ---------------


def _ref_uniforms(cfg):
    """``uniforms(stream, it, shard)``: the reference's own draws (its key split
    once per iteration, folded with the shard id)."""
    d, ns = cfg.d, cfg.mc_samples // cfg.mc_shards
    keys, subs, cache = [jax.random.PRNGKey(cfg.mc_seed)], [], {}

    def uniforms(stream, it, shard):
        while len(subs) <= it:
            key, sub = jax.random.split(keys[-1])
            keys.append(key)
            subs.append(sub)
        if (it, shard) not in cache:
            skey = jax.random.fold_in(subs[it], shard)
            cache[it, shard] = np.array(jax.random.uniform(skey, (d, ns), jnp.float64))
        return cache[it, shard]

    return uniforms


# the cases of tests/test_mc.py: its _cfg (f4 d=3), the 5-sigma Gaussian at
# d=5, and the chi^2-guard case (f6 d=3, rel_tol 1e-6: a full history)
GAUSS5 = "genz_gaussian:" + ",".join(["5.0"] * 5) + ":" + ",".join(["0.4"] * 5)
RUNS = {
    "f4-3": dict(d=3, integrand="f4", rel_tol=1e-3, backend="vegas", mc_samples=2048,
                 mc_max_iters=20),
    "genz_gaussian-5": dict(d=5, integrand=GAUSS5, rel_tol=1e-3, backend="vegas",
                            mc_samples=4096, mc_max_iters=40),
    "f6-3": dict(d=3, integrand="f6", rel_tol=1e-6, backend="vegas", mc_samples=4096,
                 mc_max_iters=25),
}


@pytest.mark.parametrize("case", sorted(RUNS))
@pytest.mark.parametrize("start", [0, 7])
def test_one_iteration_matches(case, start):
    """One iteration from the same state (fresh, or the reference's after
    ``start`` iterations) with the same uniforms."""
    fields = RUNS[case]
    jcfg, cfg = JConfig(**fields), QuadratureConfig(**fields)
    uniforms = _ref_uniforms(cfg)
    jit = jax.jit(jengine.make_iterate(jcfg, jax_fn(fields["integrand"])))
    js = jengine.init_state(jcfg)
    for _ in range(start):
        js, _ = jit(js)
    state = engine.init_state(cfg, "cpu")
    state = dataclasses.replace(
        state, edges=_t(js.edges)[None].clone(), strat_w=_t(js.strat_w)[None].clone(),
        sum_wi=_t(js.sum_wi).reshape(1).clone(), sum_w=_t(js.sum_w).reshape(1).clone(),
        sum_wi2=_t(js.sum_wi2).reshape(1).clone(), it=np.array([int(js.it)]),
        n_acc=np.array([int(js.n_acc)]), n_evals=np.array([float(js.n_evals)]),
    )
    counts = stratified.allocate_counts(state.strat_w, cfg.mc_samples, cfg.mc_min_per_cube)
    np.testing.assert_array_equal(
        counts[0].numpy(),
        np.asarray(jstrat.allocate_counts(js.strat_w, jcfg.mc_samples, jcfg.mc_min_per_cube)),
    )
    iterate = engine.make_iterate(cfg, engine.resolve_fn(cfg, None), devices=CPU,
                                  uniforms=uniforms)
    new, m = iterate(state)
    jnew, jm = jit(js)
    _close(new.edges[0], jnew.edges, 1e-12, "edges")
    _close(new.strat_w[0], jnew.strat_w, 1e-12, "strat_w")
    for k in ("sum_wi", "sum_w", "sum_wi2"):
        _close(getattr(new, k)[0], getattr(jnew, k), 1e-12, k)
    for k in ("integral", "it_integral", "it_sigma"):
        _close(m[k][0], jm[k], 1e-12, k)
    # chi^2 is a difference of accumulators: its cancellation magnifies the
    # last-bit differences, and the error carries sqrt(chi^2/dof)
    for k in ("error", "chi2_dof"):
        _close(m[k][0], jm[k], 1e-9, k)
    assert bool(m["nonfinite"][0]) == bool(jm["nonfinite"])
    assert (int(new.it[0]), int(new.n_acc[0]), float(new.n_evals[0])) == (
        int(jnew.it), int(jnew.n_acc), float(jnew.n_evals))


def jax_fn(integrand):
    from repro.core.integrands import get as jget

    return jget(integrand).fn


@pytest.mark.parametrize("case", sorted(RUNS))
def test_end_to_end_with_reference_uniforms(case):
    fields = RUNS[case]
    ref = jengine.integrate_vegas(JConfig(**fields))
    cfg = QuadratureConfig(**fields)
    iterate = engine.make_iterate(cfg, engine.resolve_fn(cfg, None), devices=CPU,
                                  uniforms=_ref_uniforms(cfg))
    got = engine.drive(cfg, iterate, device="cpu")
    assert (got.status, got.iterations, got.n_evals) == (ref.status, ref.iterations, ref.n_evals)
    _close(got.integral, ref.integral, 1e-12, "integral")
    _close(got.error, ref.error, 1e-9, "error")
    _close(got.chi2_dof, ref.chi2_dof, 1e-9, "chi2_dof")
    assert got.host_syncs == got.iterations


# --- the port's own generator: statistics and determinism ---------------------


def _cfg(**kw):
    base = dict(d=3, integrand="f4", rel_tol=1e-3, backend="vegas", mc_samples=2048,
                mc_max_iters=20)
    base.update(kw)
    return QuadratureConfig(**base)


def test_seeded_prng_determinism():
    a = engine.integrate_vegas(_cfg(), device="cpu")
    b = engine.integrate_vegas(_cfg(), device="cpu")
    assert (a.integral, a.error, a.n_evals, a.iterations) == (
        b.integral, b.error, b.n_evals, b.iterations)
    c = engine.integrate_vegas(_cfg(mc_seed=7), device="cpu")
    assert c.integral != a.integral, "another seed must draw other samples"


def test_stream_seed_is_a_function_of_its_parts():
    assert engine.stream_seed(0, 3, 5) == engine.stream_seed(0, 3, 5)
    seeds = {engine.stream_seed(s, it, shard) for s in (0, 1) for it in range(40)
             for shard in range(8)}
    assert len(seeds) == 2 * 40 * 8 and all(0 <= s < 2**63 for s in seeds)


def test_iterate_accumulates_only_after_warmup():
    cfg = _cfg(mc_warmup=3)
    iterate = engine.make_iterate(cfg, get_integrand("f4").fn, devices=CPU)
    state = engine.init_state(cfg, "cpu")
    for i in range(5):
        state, m = iterate(state)
        assert int(m["n_acc"][0]) == max(0, i + 1 - 3)
    assert float(state.n_evals[0]) == 5 * cfg.mc_samples


FAMILY_THETAS = {
    "genz_gaussian": lambda d: {"a": np.full(d, 5.0), "u": np.full(d, 0.4)},
    "genz_product_peak": lambda d: {"a": np.full(d, 5.0), "u": np.full(d, 0.6)},
    "monomial": lambda d: {"p": np.arange(d, dtype=np.float64) % 5},
}


@pytest.mark.parametrize("family", sorted(FAMILY_THETAS))
@pytest.mark.parametrize("d", [5, 10])
def test_estimate_within_5_sigma_of_exact(family, d):
    fam = PARAM_REGISTRY[family]
    theta = FAMILY_THETAS[family](d)
    spec = f"{family}:" + ":".join(
        ",".join(repr(float(v)) for v in theta[k]) for k in fam.theta_fields
    )
    cfg = QuadratureConfig(d=d, integrand=spec, rel_tol=1e-3, backend="vegas",
                           mc_samples=4096, mc_max_iters=40)
    res = engine.integrate_vegas(cfg, device="cpu")
    exact = fam.exact(d, theta)
    assert res.error > 0
    assert abs(res.integral - exact) < 5 * res.error, (spec, res, exact)
    assert res.error < 0.1 * abs(exact)


def test_chi2_guard_on_discontinuous_integrand():
    cfg = QuadratureConfig(d=3, integrand="f6", rel_tol=1e-6, backend="vegas",
                           mc_samples=4096, mc_max_iters=25)
    res = engine.integrate_vegas(cfg, device="cpu")
    assert np.isfinite(res.chi2_dof) and res.chi2_dof > 0
    exact = get_integrand("f6").exact(3)
    naive_sigma = res.error / max(np.sqrt(max(res.chi2_dof, 1.0)), 1.0)
    if res.chi2_dof > 1:
        assert res.error > naive_sigma, "inconsistency must inflate the error"
    assert abs(res.integral - exact) < 0.05 * abs(exact)


def test_result_summary_mentions_chi2():
    assert "chi2/dof" in engine.integrate_vegas(_cfg(), device="cpu").summary()


def test_chi2_single_accumulated_iteration_boundary():
    """One post-warmup iteration: no dof, chi^2/dof 0, the raw sigma, and
    no convergence however loose the tolerance."""
    cfg = QuadratureConfig(d=3, integrand="genz_gaussian", rel_tol=1e30, backend="vegas",
                           mc_samples=2048, mc_warmup=2, mc_max_iters=3)
    res = engine.integrate_vegas(cfg, integrand=lambda x: torch.prod(x, dim=0), device="cpu")
    assert res.status == "max_iters"
    assert res.iterations == 3
    assert res.chi2_dof == 0.0
    assert np.isfinite(res.error) and res.error > 0.0
    assert abs(res.integral - 0.5**3) < 5 * res.error


def test_chi2_inflation_on_discontinuous_integrand():
    cfg = QuadratureConfig(d=2, integrand="genz_gaussian", rel_tol=1e-4, backend="vegas",
                           mc_samples=512, mc_warmup=2, mc_max_iters=40)
    res = engine.integrate_vegas(
        cfg,
        integrand=lambda x: torch.where(torch.all(x < 0.5, dim=0), 1.0, 0.0).to(x.dtype),
        device="cpu",
    )
    assert res.chi2_dof > 1.0
    raw_sigma = res.error / np.sqrt(res.chi2_dof)
    assert raw_sigma < res.error
    assert np.isfinite(res.integral)
    assert abs(res.integral - 0.25) < 0.02


def test_nonfinite_integrand_is_quarantined():
    cfg = _cfg(d=2, mc_samples=512)
    res = engine.integrate_vegas(
        cfg, integrand=lambda x: torch.where(x[0] < 0.25, float("nan"), 1.0).to(x.dtype),
        device="cpu",
    )
    assert res.status == "nonfinite" and res.iterations == 1
    assert np.isfinite(res.integral)


def test_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.integrate_vegas(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrate_vegas_distributed(_cfg())


# --- ranks on the CPU ---------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["f6-3", "genz_gaussian-5"])
def test_ranks_bit_equal_to_one_rank(case, n):
    cfg = QuadratureConfig(**{**RUNS[case], "mc_max_iters": 12})
    one = engine.integrate_vegas(cfg, device="cpu")
    many = integrate_vegas_distributed(cfg, devices=CPU * n)
    assert (many.integral, many.error, many.n_evals, many.iterations, many.status) == (
        one.integral, one.error, one.n_evals, one.iterations, one.status)


def test_rank_count_must_divide_shards():
    with pytest.raises(ValueError, match="divisible"):
        integrate_vegas_distributed(_cfg(), devices=CPU * 3)


# --- the service pool ---------------------------------------------------------


def test_vegas_batch_service_end_to_end():
    from repro_torch.service import integrate_batch

    fam = get_param("genz_gaussian")
    rng = np.random.default_rng(3)
    d = 5
    thetas = [fam.sample_theta(d, rng) for _ in range(6)]
    cfg = QuadratureConfig(d=d, integrand="genz_gaussian", rel_tol=1e-3, backend="vegas",
                           batch_slots=2, mc_samples=2048, mc_max_iters=40)
    results = integrate_batch(cfg, thetas, devices=CPU)
    assert len(results) == len(thetas)
    for r in results:
        assert r.status in ("converged", "max_iters") and r.backend == "vegas"
        exact = fam.exact(d, thetas[r.req_id])
        assert abs(r.integral - exact) < 5 * r.error
        assert r.n_evals == cfg.mc_samples * r.iterations
    again = integrate_batch(cfg, thetas, devices=CPU)
    assert [(r.integral, r.error, r.iterations) for r in again] == [
        (r.integral, r.error, r.iterations) for r in results]


def test_pool_slot_equals_its_own_iterate():
    """A slot's iterations are the engine's update on that slot alone: the
    pool with one slot equals make_iterate with the slot's stream."""
    from repro_torch.mc.engine import VegasBatchEngine

    fam = get_param("genz_gaussian")
    theta = fam.sample_theta(3, np.random.default_rng(1))
    cfg = QuadratureConfig(d=3, integrand="genz_gaussian", rel_tol=1e-3, backend="vegas",
                           batch_slots=1, mc_samples=1024, mc_max_iters=12, sync_every=4)
    eng = VegasBatchEngine(cfg, devices=CPU)
    state = eng.admit(eng.init(), 0, theta)
    rows = []
    while not state.done[0]:
        state, ms, executed, _ = eng.run(state, 4, 0)
        rows += [ms["integral"][t][0] for t in range(int(executed.sum()))]
    iterate = engine.make_iterate(
        cfg, lambda x: fam.fn(x, {k: _t(v) for k, v in theta.items()}), devices=CPU)
    solo = engine.init_state(cfg, "cpu")
    solo.stream[0] = engine.stream_seed(cfg.mc_seed, 0, 1)  # slot 0, first admission
    for want in rows:
        solo, m = iterate(solo)
        assert float(m["integral"][0]) == want


def test_vegas_pool_rejects_multi_device():
    from repro_torch.mc.engine import VegasBatchEngine

    with pytest.raises(ValueError, match="single-device"):
        VegasBatchEngine(_cfg(integrand="genz_gaussian", service_devices=4), "genz_gaussian")
    with pytest.raises(ValueError, match="single-device"):
        VegasBatchEngine(_cfg(integrand="genz_gaussian"), "genz_gaussian", devices=CPU * 2)


def test_auto_backend_routes_service_by_dimension():
    from repro_torch.mc.engine import VegasBatchEngine
    from repro_torch.service.batch_engine import BatchEngine
    from repro_torch.service.scheduler import make_engine

    lo = make_engine(QuadratureConfig(d=3, integrand="genz_gaussian", backend="auto"),
                     devices=CPU)
    hi = make_engine(QuadratureConfig(d=9, integrand="genz_gaussian", backend="auto",
                                      mc_samples=2048), devices=CPU)
    assert isinstance(lo, BatchEngine) and isinstance(hi, VegasBatchEngine)


# --- the CLIs -----------------------------------------------------------------


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


def test_integrate_cli_vegas_on_cpu_ranks():
    args = ["--backend", "vegas", "--d", "4", "--integrand", "genz_gaussian",
            "--rel-tol", "1e-2", "--mc-samples", "2048", "--device", "cpu"]
    one = _cli("repro_torch.launch.integrate", *args)
    assert one.returncode == 0, one.stderr[-2000:]
    assert "chi2/dof" in one.stdout and "true_rel_err=" in one.stdout.splitlines()[-1]
    two = _cli("repro_torch.launch.integrate", *args, "--devices", "2")
    assert two.returncode == 0, two.stderr[-2000:]
    assert two.stdout.splitlines()[0] == one.stdout.splitlines()[0]  # bit-equal summary
    assert "devices=2" in two.stdout


def test_serve_quad_cli_vegas():
    ok = _cli("repro_torch.launch.serve_quad", "--device", "cpu", "--backend", "vegas",
              "--d", "4", "--n-requests", "4", "--batch-slots", "2", "--rel-tol", "1e-2",
              "--mc-samples", "1024", "--mc-iters", "30", "--validate")
    assert ok.returncode == 0, ok.stderr[-2000:]
    lines = [l for l in ok.stdout.splitlines() if l.startswith("[")]
    assert len(lines) == 4 and all("true_rel_err=" in l for l in lines)
    bad = _cli("repro_torch.launch.serve_quad", "--device", "cpu", "--backend", "vegas",
               "--devices", "2")
    assert bad.returncode != 0 and "single-device" in bad.stderr, bad.stderr[-500:]


def test_init_state_needs_a_device():
    """A state lies where its caller says: no quiet default to the CPU."""
    cfg = QuadratureConfig(d=3, backend="vegas", mc_samples=512)
    with pytest.raises(TypeError):
        engine.init_state(cfg)
    assert engine.init_state(cfg, "cpu", n=2).edges.device.type == "cpu"
