"""Region store, classify and split/compact in the port vs the JAX package.

One state is carried across with ``state_from_numpy``; one eval plus advance
then gives identical masks, counts and axes in both packages, and floats
within rtol 1e-13 (the packages sum in different orders).  In the port, a
windowed advance is bit-identical to the full one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import genz_malik as jgm
from repro.core import region_store as jrs
from repro.core import rules as jrules
from repro.core.config import QuadratureConfig as JConfig
from repro.core.split import compact as jcompact
from repro_torch.core import adaptive as tad
from repro_torch.core import region_store as trs
from repro_torch.core import split as tsplit
from repro_torch.core.config import QuadratureConfig as TConfig
from repro_torch.core.rules import make_rule

torch.set_num_threads(1)
CPU = torch.device("cpu")


def port_config(cfg: JConfig) -> TConfig:
    fields = dataclasses.asdict(cfg)
    fields.pop("use_kernel")
    fields.pop("interpret")
    return TConfig(**fields)


def jax_to_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in trs.FIELDS}


def numpy_to_jax(arrays: dict):
    return jrs.RegionState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def random_arrays(rng, C, d, n_active, tiny_frac=0.3):
    """A plausible mid-flight store: contiguous actives, duplicated error
    keys (sort stability), a share of near-zero errors (classifier fodder)."""
    centers = rng.uniform(0.1, 0.9, (C, d))
    halfw = rng.uniform(0.005, 0.1, (C, d))
    est = rng.standard_normal(C) * 10.0 ** rng.integers(-6, 3, C)
    err = np.abs(rng.standard_normal(C)) * 10.0 ** rng.integers(-12, 0, C)
    err[rng.random(C) < tiny_frac] *= 1e-14
    active = np.arange(C) < n_active
    if n_active >= 4:
        err[: n_active // 2] = err[n_active // 2 : 2 * (n_active // 2)]
    return dict(
        centers=centers,
        halfw=halfw,
        est=np.where(active, est, 0.0),
        err=np.where(active, err, 0.0),
        axis=rng.integers(0, d, C).astype(np.int32),
        active=active,
        fresh=np.zeros(C, bool),
        fin_integral=np.asarray(rng.standard_normal()),
        fin_error=np.asarray(abs(rng.standard_normal())),
        n_evals=np.asarray(0.0),
        it=np.asarray(0, np.int32),
        overflowed=np.asarray(False),
    )


def assert_states_match(ref: dict, got: dict, context=""):
    """Masks, counts and axes exactly; floats at rtol 1e-13 on the occupied
    block (freed-slot garbage beyond it is never read)."""
    n = int(ref["active"].sum())
    assert int(got["active"].sum()) == n, context
    for k in ("active", "fresh", "overflowed", "it"):
        assert np.array_equal(got[k], ref[k]), f"{context}: {k}"
    assert np.array_equal(got["axis"][:n], ref["axis"][:n]), f"{context}: axis"
    for k in ("centers", "halfw", "est", "err"):
        np.testing.assert_allclose(got[k][:n], ref[k][:n], rtol=1e-13, atol=0, err_msg=k)
    for k in ("fin_integral", "fin_error", "n_evals"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-13, atol=0, err_msg=k)


def assert_bit_identical(a, b, context=""):
    x, y = trs.state_to_numpy(a), trs.state_to_numpy(b)
    n = int(x["active"].sum())
    for k in trs.FIELDS:
        if x[k].ndim and k not in ("active", "fresh"):
            assert np.array_equal(x[k][:n], y[k][:n]), f"{context}: {k}"
        else:
            assert np.array_equal(x[k], y[k]), f"{context}: {k}"
    assert not x["active"][n:].any()


# --- store -------------------------------------------------------------------------


@pytest.mark.parametrize("d,n", [(1, 8), (3, 16), (5, 32), (8, 256)])
def test_uniform_partition_identical(d, n):
    lo, hi = np.zeros(d), np.linspace(1.0, 2.0, d)
    for a, b in zip(trs.uniform_partition(lo, hi, n), jrs.uniform_partition(lo, hi, n)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_init_state_identical(dtype):
    lo, hi = np.zeros(3), np.ones(3)
    ref = jax_to_numpy(jrs.init_state(256, lo, hi, 16, jnp.dtype(dtype)))
    got = trs.state_to_numpy(trs.init_state(256, lo, hi, 16, getattr(torch, dtype), CPU))
    for k in trs.FIELDS:
        assert got[k].dtype == ref[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k


def test_state_numpy_roundtrip():
    arrays = random_arrays(np.random.default_rng(0), 64, 3, 20)
    back = trs.state_to_numpy(trs.state_from_numpy(arrays, CPU))
    for k in trs.FIELDS:
        assert back[k].dtype == np.asarray(arrays[k]).dtype
        assert np.array_equal(back[k], arrays[k])
    with pytest.raises(KeyError, match="it"):
        trs.state_from_numpy({k: v for k, v in arrays.items() if k != "it"}, CPU)


def test_ladders_match_reference():
    for cap, wmin in [(1 << 12, 256), (256, 256), (1 << 10, 16), (64, 1000)]:
        assert trs.window_ladder(cap, wmin) == jrs.window_ladder(cap, wmin)
        ladder = trs.window_ladder(cap, wmin)
        for n in (0, 1, 15, 16, 17, 255, 256, 257, cap, cap + 1):
            assert trs.select_window(ladder, n) == jrs.select_window(ladder, n)
    for kw in ({}, {"eval_window": False}, {"advance_window": False},
               {"eval_window_min": 16}):
        jc = JConfig(d=3, capacity=1 << 12, **kw)
        assert tad.eval_ladder(port_config(jc)) == jad.eval_ladder(jc)
        assert tad.advance_ladder(port_config(jc)) == jad.advance_ladder(jc)
    for n in (0, 5, 2048, 4096):
        assert tad.advance_target(n, 4096) == jad.advance_target(n, 4096)


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 1000])
def test_tree_sum_ignores_trailing_zeros(n):
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(n) * 1e3)
    s = trs.tree_sum(x)
    for extra in (1, 13, 1024):
        assert trs.tree_sum(torch.cat([x, torch.zeros(extra, dtype=x.dtype)])) == s
    np.testing.assert_allclose(float(s), float(x.sum()), rtol=1e-12, atol=1e-9)


# --- one step from a carried state ----------------------------------------------------


def _jax_trajectory(cfg, n_steps):
    """States of the JAX host driver's loop, each just after an advance."""
    cfg, lo, hi, total_volume, rule, state = jad._setup(cfg, None)
    ev = jax.jit(jad.make_eval_step(cfg, rule))
    adv = jax.jit(jad.make_advance_step(cfg, total_volume, hi - lo))
    out = []
    for _ in range(n_steps):
        state = adv(ev(state))
        out.append(state)
    return out, ev, adv, total_volume, hi - lo


def _region_table(arrays):
    """The occupied block's rows in a canonical order (sorted by centre and
    half-width), for comparisons that must not depend on how near-equal
    error keys were ordered."""
    n = int(arrays["active"].sum())
    c, h = arrays["centers"][:n], arrays["halfw"][:n]
    order = np.lexsort(tuple(np.concatenate([c, h], axis=1).T[::-1]))
    return {k: arrays[k][:n][order] for k in ("centers", "halfw", "est", "err", "axis", "fresh")}


def _assert_eval_close(ref: dict, got: dict, diffs_ref, context):
    """One eval from one state.  Estimates agree at rtol 1e-13; error
    estimates, differences of near-equal estimates, to 1e-13 of the
    estimate; masks exactly.  Split axes agree, except where the
    reference's two candidate fourth differences tie to 1e-12: a last-bit
    difference then picks the other axis (ROADMAP.md, queue 3).  Returns
    the number of such rows."""
    n = int(ref["active"].sum())
    for k in ("active", "fresh", "overflowed", "it"):
        assert np.array_equal(got[k], ref[k]), f"{context}: {k}"
    est, ge = ref["est"][:n], got["est"][:n]
    np.testing.assert_allclose(ge, est, rtol=1e-13, atol=0)
    d_err = np.abs(got["err"][:n] - ref["err"][:n])
    assert np.all(d_err <= 1e-13 * np.maximum(np.abs(est), np.abs(ref["err"][:n]))), context
    np.testing.assert_allclose(got["n_evals"], ref["n_evals"], rtol=0, atol=0)
    rows = np.nonzero(got["axis"][:n] != ref["axis"][:n])[0]
    for r in rows:
        a, b = ref["axis"][r], got["axis"][r]
        np.testing.assert_allclose(diffs_ref[r, b], diffs_ref[r, a], rtol=1e-12)
    return len(rows)


@pytest.mark.parametrize(
    "name,classifier",
    [("f4", "robust"), ("f2", "aggressive"), ("f6", "robust"),
     ("genz_gaussian:6,4,5:0.3,0.7,0.5", "aggressive")],
)
def test_one_eval_and_advance_match(name, classifier):
    """From one carried state: one eval agrees (see _assert_eval_close);
    the advance from the same evaluated state agrees row by row; and eval +
    advance in the port gives the same counts and masks.  Where no axis
    tied, it also gives the same regions with the same axes (compared as a
    set: regions whose errors tie to the last bit may sort the other way
    round)."""
    jc = JConfig(d=3, integrand=name, classifier=classifier, rel_tol=1e-7, capacity=1 << 11)
    states, ev, adv, total_volume, width = _jax_trajectory(jc, 6)
    tc = port_config(jc)
    rule = make_rule(tc)
    jrule = jrules.make_rule(jc)
    advance = tad.make_advance_step(tc, total_volume, width)
    for i in (0, 2, 5):
        arrays = jax_to_numpy(states[i])
        ref_eval = jax_to_numpy(ev(numpy_to_jax(arrays)))
        ref = jax_to_numpy(adv(numpy_to_jax(ref_eval)))
        t = tad.make_eval_step(tc, rule)(trs.state_from_numpy(arrays, CPU))
        diffs_ref = np.asarray(
            jgm.gm_eval_reference(
                jrule.f if jrule.theta is None else (lambda x: jrule.f(x, jrule.theta)),
                jnp.asarray(arrays["centers"]), jnp.asarray(arrays["halfw"]),
            )[3]
        )
        ties = _assert_eval_close(ref_eval, trs.state_to_numpy(t), diffs_ref, f"eval {i}")
        from_ref = advance(trs.state_from_numpy(ref_eval, CPU))
        assert_states_match(ref, trs.state_to_numpy(from_ref), f"advance {i}")
        got = trs.state_to_numpy(advance(t))
        for k in ("active", "fresh", "overflowed", "it"):
            assert np.array_equal(got[k], ref[k]), f"eval+advance {i}: {k}"
        for k in ("fin_integral", "n_evals"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-13, atol=0)
        # fin_error sums error estimates, which carry their bar above
        scale = abs(float(ref["fin_error"])) + np.abs(ref_eval["est"]).sum()
        assert abs(float(got["fin_error"]) - float(ref["fin_error"])) <= 1e-13 * scale
        if ties:
            continue
        a, b = _region_table(ref), _region_table(got)
        for k in ("centers", "halfw", "axis", "fresh"):
            assert np.array_equal(b[k], a[k]), f"eval+advance {i}: {k}"
        np.testing.assert_allclose(b["est"], a["est"], rtol=1e-13, atol=0)


ADVANCE_CASES = [
    # (capacity, population share, classifier, seed)
    (256, 0.3, "robust", 0),
    (256, 0.3, "aggressive", 1),
    (512, 0.55, "robust", 2),
    (128, 0.97, "robust", 3),  # past 3C/4: forced finalise
    (128, 0.97, "aggressive", 4),
    (256, 1.0, "robust", 5),  # full store
    (256, 0.0, "robust", 6),  # empty store
]


@pytest.mark.parametrize("C,pop,classifier,seed", ADVANCE_CASES)
def test_one_advance_matches(C, pop, classifier, seed):
    d = 3
    n = int(round(pop * C))
    pressure = pop > 0.75
    # under pressure, a tight tolerance and no near-zero errors keep the
    # classifier from finalising its way out of the forced-finalise path
    arrays = random_arrays(
        np.random.default_rng(seed), C, d, n, tiny_frac=0.0 if pressure else 0.3
    )
    jc = JConfig(d=d, capacity=C, classifier=classifier, n_init=8,
                 rel_tol=1e-15 if pressure else 1e-6)
    width = np.ones(d)
    ref = jax_to_numpy(jad.make_advance_step(jc, 1.0, width)(numpy_to_jax(arrays)))
    tc = port_config(jc)
    got = trs.state_to_numpy(
        tad.make_advance_step(tc, 1.0, width)(trs.state_from_numpy(arrays, CPU))
    )
    assert_states_match(ref, got, f"C={C} n={n}")
    # survivors are gathered, never computed: their order is exact
    m = int(ref["active"].sum())
    assert np.array_equal(got["err"][:m], ref["err"][:m])
    if pressure:
        assert bool(got["overflowed"])
        assert got["fin_integral"] != arrays["fin_integral"]


# --- the port's windowed advance ----------------------------------------------------------


@pytest.mark.parametrize("case", range(16))
def test_windowed_advance_bit_identical(case):
    rng = np.random.default_rng(2000 + case)
    C = 1 << int(rng.integers(6, 10))
    d = int(rng.integers(1, 5))
    n = int(round(float(rng.random()) * C))
    arrays = random_arrays(rng, C, d, n)
    cfg = TConfig(d=d, capacity=C, n_init=8, eval_window_min=16,
                  classifier=("robust", "aggressive")[case % 2], rel_tol=1e-6)
    full = tad.make_advance_step(cfg, 1.0, np.ones(d))(trs.state_from_numpy(arrays, CPU))
    target = tad.advance_target(n, C)
    for w in [r for r in trs.window_ladder(C, 16) if r >= target]:
        win = tad.make_advance_step(cfg, 1.0, np.ones(d), window=w)(
            trs.state_from_numpy(arrays, CPU)
        )
        assert_bit_identical(full, win, f"C={C} n={n} w={w}")


@pytest.mark.parametrize("case", range(6))
def test_windowed_compact_bit_identical(case):
    rng = np.random.default_rng(3000 + case)
    C = 1 << int(rng.integers(6, 9))
    n = int(round(float(rng.random()) * C))
    arrays = random_arrays(rng, C, 3, n)
    arrays["active"] = rng.random(C) < 0.5  # scattered actives to compact
    n = int(arrays["active"].sum())
    full = tsplit.compact(trs.state_from_numpy(arrays, CPU))
    w = C  # scattered actives: only the full window holds them all
    win = tsplit.compact(trs.state_from_numpy(arrays, CPU), window=w)
    assert_bit_identical(full, win)
    ref = jax_to_numpy(jcompact(numpy_to_jax(arrays)))
    got = trs.state_to_numpy(full)
    for k in ("centers", "halfw", "est", "err", "axis", "active", "fresh"):
        assert np.array_equal(got[k][:n], ref[k][:n]), k


@pytest.mark.parametrize("case", range(8))
def test_host_population_count_matches_device(case):
    """integrate() sizes its windows from split.next_population, never
    syncing the post-split count: it must equal the store's count."""
    rng = np.random.default_rng(4000 + case)
    C = 1 << int(rng.integers(6, 10))
    n = int(round(float(rng.random()) * C))
    arrays = random_arrays(rng, C, 2, n)
    state = trs.state_from_numpy(arrays, CPU)
    fin = torch.as_tensor(rng.random(C) < 0.3) & state.active
    n_fin = int(fin.sum())
    state = tsplit.classify_split_compact(state, fin)
    assert int(state.active.sum()) == tsplit.next_population(n - n_fin, C)
    trs.check_invariants(state, np.zeros(2), np.ones(2) + 1.0)


# --- quarantine -------------------------------------------------------------------------


def test_quarantine_zeroes_nan_region():
    arrays = random_arrays(np.random.default_rng(9), 64, 2, 20)
    arrays["est"][3] = np.nan
    arrays["err"][7] = np.inf
    ref_state, ri, re, rn = jad.quarantine_step(numpy_to_jax(arrays))
    state, gi, ge, na = tad.quarantine_step(trs.state_from_numpy(arrays, CPU))
    got = trs.state_to_numpy(state)
    assert got["est"][3] == 0.0 and got["err"][7] == 0.0
    assert not got["active"][3] and not got["active"][7]
    assert int(na) == int(rn) == 18
    assert np.isfinite(float(gi)) and np.isfinite(float(ge))
    np.testing.assert_allclose([float(gi), float(ge)], [float(ri), float(re)], rtol=1e-13)
    assert np.array_equal(got["active"], np.asarray(ref_state.active))


def test_integrate_reports_nonfinite():
    def nan_left(x):
        return torch.log(x[0] - 0.3)  # NaN for x0 < 0.3

    res = tad.integrate(TConfig(d=2, capacity=1 << 8), nan_left, device="cpu")
    assert res.status == "nonfinite"
    assert np.isfinite(res.integral) and np.isfinite(res.error)
