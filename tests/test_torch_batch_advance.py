"""The port's advance over a leading slot axis, the stacked store helpers,
and the GM evaluation with one theta column per slot (CPU; the kernel's
form on the card at the end, marked gpu)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import adaptive as tad
from repro_torch.core import region_store as trs
from repro_torch.core.classify import classify
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import PARAM_REGISTRY
from repro_torch.core.split import (
    ROWS,
    SCALARS,
    classify_split_compact,
    split_compact_rows,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import genz_malik_eval_soa_ref

torch.set_num_threads(1)

# d = 3 regions per slot, S = 5 slots: d != S, so a .T that reversed all
# axes of an (S, w, d) array would give the wrong shape or the wrong values
D, S = 3, 5


def _slot_states(cfg, steps, integrand):
    """One evaluated store per entry of ``steps``: ``steps[s]`` eval+advance
    iterations from the initial partition, then one evaluate step."""
    cpu = torch.device("cpu")
    states = []
    for n in steps:
        cfg_, lo, hi, vol, rule, st = tad._setup(cfg, integrand, cpu)
        ev = tad.make_eval_step(cfg_, rule)
        adv = tad.make_advance_step(cfg_, vol, hi - lo)
        for _ in range(n):
            st = adv(ev(st))
        states.append(ev(st))
    return states, vol, torch.as_tensor(hi - lo)


@pytest.mark.parametrize("classifier", ["robust", "aggressive"])
@pytest.mark.parametrize("integrand,capacity", [("f4", 1 << 11), ("f2", 1 << 8)])
def test_batched_advance_equals_single_store_advances(integrand, capacity, classifier):
    """Five slots of different populations, advanced together on one shared
    window, equal five single-store advances bit for bit.  Capacity 2^8
    puts the later slots under capacity pressure (forced finalisation)."""
    cfg = QuadratureConfig(d=D, integrand=integrand, rel_tol=1e-7, capacity=capacity,
                           classifier=classifier).validate()
    C = cfg.capacity
    states, vol, width = _slot_states(cfg, [0, 1, 2, 4, 6], None)
    counts = [int(st.active.sum()) for st in states]
    assert len(set(counts)) > 2, counts  # different populations
    # per-slot tolerances, as the service passes them
    rel = torch.tensor([1e-7, 1e-5, 1e-7, 1e-6, 1e-7], dtype=torch.float64)
    abs_tol = torch.full((S,), cfg.abs_tol, dtype=torch.float64)
    ladder = tad.advance_ladder(cfg)
    shared = trs.select_window(ladder, tad.advance_target(max(counts), C))

    singles = []
    for s, st in enumerate(states):
        st = dataclasses.replace(st, **{k: getattr(st, k).clone() for k in trs.FIELDS})
        w = trs.select_window(ladder, tad.advance_target(counts[s], C))
        c = dataclasses.replace(cfg, rel_tol=float(rel[s]))
        _, _, fin = tad.classify_window(c, st, vol, width, w)
        singles.append(classify_split_compact(st, fin, window=w))

    stack = trs.stacked_empty_state(S, C, D, torch.float64, "cpu")
    for s, st in enumerate(states):
        trs.write_slot(stack, s, st)
    rows = {k: getattr(stack, k)[:, :shared] for k in ROWS}
    scalars = {k: getattr(stack, k) for k in SCALARS}
    sums = trs.masked_sums(rows["active"], rows["est"], rows["err"])
    integral = stack.fin_integral + sums[0]
    budget = torch.maximum(abs_tol, torch.abs(integral) * rel)
    fin = classify(cfg, rows["est"], rows["err"], rows["halfw"], rows["active"],
                   integral[:, None], vol, width, budget=budget[:, None],
                   rel_tol=rel[:, None])
    assert fin.shape == (S, shared)
    new_rows, new_scalars = split_compact_rows(C, rows, scalars, fin)

    for s, single in enumerate(singles):
        for k in ROWS:
            got = new_rows[k][s]
            want = getattr(single, k)[:shared]
            assert torch.equal(got, want), (s, k)
            assert not getattr(single, k)[shared:].any() or k in ("centers", "halfw"), (s, k)
        for k in SCALARS:
            assert torch.equal(new_scalars[k][s], getattr(single, k)), (s, k)
    assert any(bool(single.overflowed) for single in singles) == (capacity == 1 << 8)


def test_classify_batched_volume_uses_the_axis_of_d():
    """classify on (S, w, d) half-widths: the volume is the product over the
    last axis of each region (the .T hazard: .T of an (S, w, d) array is
    (d, w, S))."""
    cfg = QuadratureConfig(d=D, capacity=64, rel_tol=1e-3).validate()
    rng = np.random.default_rng(0)
    halfw = torch.as_tensor(rng.uniform(0.01, 0.2, (S, 16, D)))
    est = torch.as_tensor(rng.uniform(0.0, 1.0, (S, 16)))
    err = torch.as_tensor(rng.uniform(0.0, 1e-3, (S, 16)))
    active = torch.ones(S, 16, dtype=torch.bool)
    width = torch.ones(D, dtype=torch.float64)
    budget = torch.as_tensor(rng.uniform(1e-3, 1e-1, (S, 1)))
    got = classify(cfg, est, err, halfw, active, None, 1.0, width, budget=budget)
    for s in range(S):
        want = classify(cfg, est[s], err[s], halfw[s], active[s], None, 1.0, width,
                        budget=budget[s, 0])
        assert torch.equal(got[s], want), s


def test_stacked_empty_state_and_write_slot():
    stack = trs.stacked_empty_state(S, 32, D, torch.float64, "cpu")
    one = trs.empty_state(32, D, torch.float64, "cpu")
    for k in trs.FIELDS:
        a, b = getattr(stack, k), getattr(one, k)
        assert a.shape == (S,) + b.shape and a.dtype == b.dtype, k
        assert not a.any(), k
    st = trs.init_state(32, np.zeros(D), np.ones(D), 8, torch.float64, "cpu")
    st.n_evals += 17
    assert trs.write_slot(stack, 3, st) is stack
    for k in trs.FIELDS:
        assert torch.equal(getattr(stack, k)[3], getattr(st, k)), k
        for s in (0, 1, 2, 4):
            assert not getattr(stack, k)[s].any(), (s, k)
    # a second write replaces the whole slice, stale rows included
    trs.write_slot(stack, 3, trs.empty_state(32, D, torch.float64, "cpu"))
    assert not stack.active.any() and not stack.centers.any()
    for bad in (-1, S):
        with pytest.raises(IndexError, match="out of range"):
            trs.write_slot(stack, bad, st)


def _theta_cols(name, d, n, rng):
    entry = PARAM_REGISTRY[name]
    thetas = [entry.sample_theta(d, rng) for _ in range(n)]
    cols = np.stack([np.concatenate([t[k] for k in entry.theta_fields]) for t in thetas], 1)
    return entry, thetas, torch.as_tensor(cols)


# Lanes per slot are multiples of 16, as the service's windows (powers of
# two from eval_window_min) are: PyTorch's CPU kernels compute exp and pow
# with vector code in blocks and with scalar code on a ragged tail, which
# round differently, so on the CPU a lane's bits depend on where it sits
# modulo the vector block.  (The CUDA kernel computes every lane alike.)
@pytest.mark.parametrize("name", sorted(PARAM_REGISTRY))
@pytest.mark.parametrize("d,lanes", [(2, 16), (3, 64), (5, 256)])
def test_theta_columns_equal_per_slot_broadcast_calls(name, d, lanes):
    """The plain version with one theta column per slot equals one
    broadcast call per slot, bit for bit."""
    rng = np.random.default_rng(d * 31 + lanes)
    n = 4
    entry, thetas, cols = _theta_cols(name, d, n, rng)
    c = torch.as_tensor(rng.uniform(0.1, 0.9, (n * lanes, d)))
    h = torch.as_tensor(rng.uniform(0.01, 0.1, (n * lanes, d)))
    got = ops.genz_malik_eval(entry, c, h, theta_cols=cols)
    for s in range(n):
        part = slice(s * lanes, (s + 1) * lanes)
        want = ops.genz_malik_eval(entry, c[part], h[part], theta=thetas[s])
        for g, w in zip(got, want):
            assert torch.equal(g[part], w), (name, s)


def test_theta_columns_are_checked():
    entry = PARAM_REGISTRY["genz_gaussian"]
    c = torch.full((12, 2), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="divide"):
        ops.genz_malik_eval(entry, c, c * 0.1, theta_cols=torch.ones(4, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="not both"):
        ops.genz_malik_eval(entry, c, c * 0.1, theta={"a": np.ones(2), "u": np.ones(2)},
                            theta_cols=torch.ones(4, 3, dtype=torch.float64))


@pytest.mark.parametrize("lanes", [1, 7, 1000])
def test_plain_version_expands_columns(lanes):
    """genz_malik_eval_soa_ref's lanes_per_col form is the materialised
    per-lane form, a block of lanes straddling two slots included."""
    rng = np.random.default_rng(5)
    entry, _, cols = _theta_cols("genz_product_peak", 3, 3, rng)
    ct = torch.as_tensor(rng.uniform(0.1, 0.9, (3, 3 * lanes)))
    ht = torch.as_tensor(rng.uniform(0.01, 0.1, (3, 3 * lanes)))

    def fn(x, r):
        return entry.fn(x, dict(zip(entry.theta_fields, r.split(3))))

    got = genz_malik_eval_soa_ref(fn, ct, ht, cols, lanes_per_col=lanes)
    want = genz_malik_eval_soa_ref(fn, ct, ht, cols.repeat_interleave(lanes, dim=1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 7, 256, 1000])
def test_kernel_theta_columns_match_plain_on_card(lanes):
    """On the card: the kernel's per-slot theta columns against the plain
    version, at the float64 bar of tests/test_kernels.py (rtol 1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import genz_malik_eval as gm_kernel

    rng = np.random.default_rng(lanes)
    for name in ("genz_gaussian", "genz_product_peak"):
        entry, _, cols = _theta_cols(name, 5, 3, rng)
        ct = torch.as_tensor(rng.uniform(0.1, 0.9, (5, 3 * lanes)), device="cuda")
        ht = torch.as_tensor(rng.uniform(0.01, 0.1, (5, 3 * lanes)), device="cuda")
        cols = cols.cuda()
        got = gm_kernel.genz_malik_eval_soa(entry.kernel_id, ct, ht, cols, lanes_per_col=lanes)

        def fn(x, r, entry=entry):
            return entry.fn(x, dict(zip(entry.theta_fields, r.split(5))))

        want = genz_malik_eval_soa_ref(fn, ct, ht, cols, lanes_per_col=lanes)
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-300)
