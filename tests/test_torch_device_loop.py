"""The port's device-resident driver: equal to its host driver, bit for bit,
and to the JAX package's ``integrate_device``."""

import math

import jax.numpy as jnp
import pytest
import torch

from repro.core import adaptive as jad
from repro.core.config import QuadratureConfig as JConfig
from repro_torch.core import adaptive as tad
from repro_torch.core import region_store
from repro_torch.core.config import QuadratureConfig as TConfig

torch.set_num_threads(1)

# cases of tests/test_adaptive.py:11 that run in seconds on the CPU
CASES = [
    ("f1", 3, 1e-7, 1 << 15),
    ("f2", 3, 1e-6, 1 << 15),
    ("f4", 3, 1e-7, 1 << 15),
    ("f5", 3, 1e-5, 1 << 15),
    ("f6", 3, 1e-4, 1 << 15),
]


@pytest.mark.parametrize("landed", ["at once", "never"])
@pytest.mark.parametrize("sync_every", [1, 4, 7])
@pytest.mark.parametrize("name,d,rel_tol,capacity", CASES)
def test_device_loop_equals_host_loop(name, d, rel_tol, capacity, sync_every, landed,
                                      monkeypatch):
    # "never": no count copy lands before the block's sync (a host far
    # ahead of the device), so every window comes from the upper bound
    if landed == "never":
        monkeypatch.setattr(tad, "_landed", lambda event: False)
    cfg = TConfig(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity,
                  max_iters=400, sync_every=sync_every)
    host = tad.integrate(cfg, device="cpu")
    dev = tad.integrate_device(cfg, device="cpu")
    assert dev.status == host.status == "converged"
    assert (dev.integral, dev.error, dev.iterations, dev.n_evals) == (
        host.integral, host.error, host.iterations, host.n_evals
    )
    assert (dev.n_active, dev.overflowed) == (host.n_active, host.overflowed)
    assert dev.host_syncs <= math.ceil(dev.iterations / sync_every) + 2
    assert host.host_syncs == host.iterations + 2  # one per evaluate step, one at the end
    # evaluate steps past the stop: none when every snapshot lands at once;
    # the rest of the last block when none lands before its read
    steps = dev.host_syncs * sync_every if landed == "never" else dev.iterations + 1
    assert dev.discarded == steps - (dev.iterations + 1)


@pytest.mark.parametrize("sync_every", [1, 2, 4, 8])
@pytest.mark.parametrize("name,d,rel_tol,capacity", [CASES[0], CASES[2]])
def test_landed_stop_discards_nothing(name, d, rel_tol, capacity, sync_every, monkeypatch):
    monkeypatch.setattr(tad, "_landed", lambda event: True)
    kw = dict(d=d, integrand=name, rel_tol=rel_tol, capacity=capacity, max_iters=400)
    one = tad.integrate_device(TConfig(**kw, sync_every=1), device="cpu")
    got = tad.integrate_device(TConfig(**kw, sync_every=sync_every), device="cpu")
    assert (got.status, got.integral, got.error, got.iterations, got.n_evals, got.n_active) == (
        one.status, one.integral, one.error, one.iterations, one.n_evals, one.n_active)
    assert one.status == "converged" and got.discarded == one.discarded == 0
    assert got.host_syncs == math.ceil((got.iterations + 1) / sync_every)


@pytest.mark.parametrize(
    "late,discarded",
    [(1, 0), (2, 0), (3, 1), (4, 1)],
    ids=["before-its-advance", "after-its-advance", "before-next-advance", "after-next-advance"],
)
def test_abandoned_steps_are_never_read(monkeypatch, late, discarded):
    """The stop's snapshot lands ``late`` stages (evaluate, advance) after
    the stop's evaluate step begins, none landing before: the loop enqueues
    nothing after the next check.  The state is poisoned with NaN from the
    stop's snapshot on; the result does not move."""
    cfg = TConfig(d=3, integrand="f4", rel_tol=1e-7, capacity=1 << 15, max_iters=400,
                  sync_every=8)
    host = tad.integrate(cfg, device="cpu")
    s = host.iterations  # index of the evaluate step that converges
    assert s % 8 != 7  # the next step is in the same block
    log = []
    monkeypatch.setattr(tad, "_landed", lambda event: len(log) >= 2 * s + late)

    def poison(st):
        if len(log) >= 2 * s + 1:
            for field in ("centers", "halfw", "est", "err", "fin_integral", "fin_error"):
                getattr(st, field).fill_(float("nan"))

    make_eval_step, split = tad.make_eval_step, tad.classify_split_compact

    def spy_eval(cfg, rule, window=None):
        step = make_eval_step(cfg, rule, window=window)

        def run(st):
            poison(st)
            log.append("eval")
            return step(st)
        return run

    def spy_split(st, fin, window=None):
        poison(st)
        log.append("advance")
        return split(st, fin, window)

    monkeypatch.setattr(tad, "make_eval_step", spy_eval)
    monkeypatch.setattr(tad, "classify_split_compact", spy_split)
    got = tad.integrate_device(cfg, device="cpu")
    assert (got.status, got.integral, got.error, got.iterations, got.n_evals) == (
        host.status, host.integral, host.error, host.iterations, host.n_evals)
    assert got.discarded == discarded
    assert len(log) == 2 * s + late


@pytest.mark.parametrize("max_iters", [400, 14])
@pytest.mark.parametrize("landed", ["at once", "never"])
@pytest.mark.parametrize("sync_every", [1, 4])
def test_eval_rows_against_a_recount(sync_every, landed, max_iters, monkeypatch):
    """``eval_rows`` sums the windows of every evaluate step enqueued,
    ``eval_rows_exact`` the windows of each step's exact population; they
    are equal when every window comes from an exact count.  At 14 the run
    ends at ``max_iters``, with one snapshot more than evaluate steps."""
    cfg = TConfig(d=3, integrand="f4", rel_tol=1e-7, capacity=1 << 15, max_iters=max_iters,
                  sync_every=sync_every)
    host = tad.integrate(cfg, device="cpu")
    if landed == "never":
        monkeypatch.setattr(tad, "_landed", lambda event: False)
    ladder = tad.eval_ladder(cfg)
    windows, exact = [], []
    make_eval_step = tad.make_eval_step

    def spy(cfg, rule, window=None):
        step = make_eval_step(cfg, rule, window=window)

        def run(st):
            windows.append(window)
            exact.append(region_store.select_window(ladder, int(st.active.sum())))
            return step(st)
        return run

    monkeypatch.setattr(tad, "make_eval_step", spy)
    got = tad.integrate_device(cfg, device="cpu")
    if max_iters == 14:
        assert got.status == "max_iters" and len(windows) == 14
    else:
        assert len(windows) == got.iterations + 1 + got.discarded
    assert (got.eval_rows, got.eval_rows_exact) == (sum(windows), sum(exact))
    if sync_every == 1 or landed == "at once":
        assert got.eval_rows == got.eval_rows_exact
    else:
        assert got.eval_rows > got.eval_rows_exact
    # the host loop sizes every window from the exact count
    assert host.eval_rows == host.eval_rows_exact == sum(exact[:host.iterations + 1])


def test_matches_reference_device_loop():
    """The case of tests/test_adaptive.py:38."""
    kw = dict(d=4, integrand="f4", rel_tol=1e-6, capacity=1 << 13)
    ref = jad.integrate_device(JConfig(**kw))
    got = tad.integrate_device(TConfig(**kw), device="cpu")
    assert got.status == ref.status == "converged"
    assert got.integral == pytest.approx(ref.integral, rel=1e-9)
    assert (got.iterations, got.n_evals) == (ref.iterations, ref.n_evals)


@pytest.mark.parametrize(
    "kw",
    [
        # cut by max_iters: the result is the state after its last advance
        dict(d=4, integrand="f4", rel_tol=1e-6, capacity=1 << 13, max_iters=5),
        dict(d=3, integrand="f4", rel_tol=1e-9, capacity=1 << 10, max_iters=9, sync_every=3),
        # capacity pressure until the store runs dry
        dict(d=3, integrand="f2", rel_tol=1e-9, capacity=1 << 9, max_iters=40),
    ],
    ids=["max-iters-5", "max-iters-block-edge", "capacity"],
)
def test_edge_exits_match_reference(kw, monkeypatch):
    monkeypatch.setattr(tad, "_landed", lambda event: False)
    ref = jad.integrate_device(JConfig(**kw))
    got = tad.integrate_device(TConfig(**kw), device="cpu")
    assert (got.status, got.iterations, got.n_evals, got.n_active, got.overflowed) == (
        ref.status, ref.iterations, ref.n_evals, ref.n_active, ref.overflowed
    )
    assert got.integral == pytest.approx(ref.integral, rel=1e-9)
    assert got.error == pytest.approx(ref.error, rel=1e-9)


def test_nonfinite_runs_to_max_iters_like_reference():
    kw = dict(d=2, integrand="f4", rel_tol=1e-6, capacity=1 << 10, max_iters=6)

    def bad_t(x):
        return torch.where(x[0] > 0.7, torch.full_like(x[0], float("nan")), torch.ones_like(x[0]))

    def bad_j(x):
        return jnp.where(x[0] > 0.7, jnp.nan, 1.0)

    ref = jad.integrate_device(JConfig(**kw), bad_j)
    got = tad.integrate_device(TConfig(**kw), bad_t, device="cpu")
    assert got.status == ref.status == "nonfinite"
    assert (got.iterations, got.n_evals) == (ref.iterations, ref.n_evals)


def test_device_loop_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TConfig(d=2, capacity=1 << 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tad.integrate_device(cfg)
    assert tad.integrate_device(cfg, device="cpu").status == "converged"
