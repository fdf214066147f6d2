"""The VEGAS pool's fused dispatch on the CPU, against the JAX pool.

``repro_torch.mc.engine.VegasBatchEngine.run`` runs up to ``sync_every``
iterations with one host read, its slot decisions made on the device, as
the JAX pool's ``lax.scan`` over ``lax.cond`` does.  The JAX pool is
single-device, so it runs in process (one engine compiled a
``sync_every``, shared by every run of this file):

- (a) the scheduler at K = ``sync_every`` 1 and 4 and ``admit_every`` 1
  and 4, with tolerances striped so that slots finish at different
  iterations (some at ``mc_max_iters``), the port's pool fed the JAX pool's
  draws (slot s at admission q keyed by ``fold_in(fold_in(PRNGKey(mc_seed),
  s), q)``, split once an iteration, folded with the shard): status,
  iterations, ``n_evals``, ``admitted_at``, ``finished_at`` and
  ``last_stats``' dispatches and iterations equal; the integral within rtol
  1e-12 and the error within rtol 1e-9 (tests/test_torch_mc.py's whole-run
  bars);
- (b) ``run`` against the JAX engine's ``run``, dispatch by dispatch, on a
  fleet in which a slot finishes at the second iteration of a K = 4
  dispatch: ``executed`` and, at the slots live in each iteration, ``done``,
  ``occupied``, ``it``, ``converged`` and ``nonfinite`` equal, the integral
  and error within (a)'s bars;
- (c) with the port's own generator, the results at K = 1, 4 and 16 are
  bit-equal within each ``admit_every``;
- (d) one host read per dispatch and one wait on a landed row per
  iteration; one sums call per executed iteration; a K = 8 dispatch that
  stops at a finish leaves the pool byte for byte as K = 1 dispatches to
  the same iteration; a run on an empty pool reads nothing;
- (e) the float32 decision: a budget in float32, as the JAX pool's, where
  a float64 budget decides otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.mc.engine import MIN_ACCUMULATED as J_MIN_ACCUMULATED
from repro.mc.engine import VegasBatchEngine as JPool
from repro.service import BatchScheduler as JScheduler
from repro.service import QuadRequest as JRequest
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.mc import engine
from repro_torch.service import BatchScheduler, QuadRequest

torch.set_num_threads(1)

CPU = ["cpu"]
FAMILY = get_param("genz_gaussian")
FIELDS = dict(d=4, integrand="genz_gaussian", backend="vegas", batch_slots=4, mc_samples=1024,
              mc_warmup=4, mc_max_iters=16, rel_tol=1e-2)
TOLS = (3e-2, 2e-3, 8e-3)  # rel_tol of request indices 0, 1, 2 mod 3
N_REQUESTS = 12
KS = (1, 4)
ADMIT = (1, 4)
# (b): slot -> (rel_tol, abs_tol).  With mc_warmup 4 a slot may converge
# from its sixth iteration on: slot 2, at abs_tol 1, finishes there, the
# second iteration of the second K = 4 dispatch.
LAYOUT = {0: (2e-3, 0.0), 1: (8e-3, 0.0), 2: (1e-2, 1.0), 3: (4e-3, 0.0)}
RUN_K = 4


def _thetas():
    rng = np.random.default_rng(3)
    return [FAMILY.sample_theta(FIELDS["d"], rng) for _ in range(N_REQUESTS)]


def _requests(cls=QuadRequest):
    return [cls(req_id=i, theta=t, rel_tol=TOLS[i % 3]) for i, t in enumerate(_thetas())]


def pool_uniforms(cfg):
    """``uniforms(stream, it, shard)``: the JAX pool's draws of the slot and
    admission that ``stream`` names."""
    d, ns = cfg.d, cfg.mc_samples // cfg.mc_shards
    by_stream = {engine.stream_seed(cfg.mc_seed, s, q): (s, q)
                 for s in range(cfg.batch_slots) for q in range(1, N_REQUESTS + 1)}
    base = jax.random.PRNGKey(cfg.mc_seed)
    keys, subs, cache = {}, {}, {}

    def uniforms(stream, it, shard):
        slot, seq = by_stream[stream]
        if (slot, seq) not in keys:
            keys[slot, seq] = jax.random.fold_in(jax.random.fold_in(base, slot), seq)
            subs[slot, seq] = []
        while len(subs[slot, seq]) <= it:
            keys[slot, seq], sub = jax.random.split(keys[slot, seq])
            subs[slot, seq].append(sub)
        if (slot, seq, it, shard) not in cache:
            skey = jax.random.fold_in(subs[slot, seq][it], shard)
            cache[slot, seq, it, shard] = np.array(jax.random.uniform(skey, (d, ns), jnp.float64))
        return cache[slot, seq, it, shard]

    return uniforms


def _tuple(r):
    return (r.req_id, r.integral.hex(), r.error.hex(), r.status, r.iterations, r.n_evals,
            r.admitted_at, r.finished_at)


def _fields(r):
    return (r.status, r.iterations, r.n_evals, r.admitted_at, r.finished_at)


@pytest.fixture(scope="module")
def jax_pools():
    return {K: JPool(JConfig(**FIELDS, sync_every=K)) for K in KS}


@pytest.fixture(scope="module")
def reference(jax_pools):
    out = {}
    for K, pool in jax_pools.items():
        cfg = pool.cfg
        for adm in ADMIT:
            # the scheduler reads admit_every from its engine's cfg; the
            # compiled dispatch does not depend on it
            pool.cfg = dataclasses.replace(cfg, admit_every=adm)
            sched = JScheduler(pool.cfg, engine=pool)
            results = sorted(sched.serve(_requests(JRequest)), key=lambda r: r.req_id)
            out[K, adm] = results, dict(sched.last_stats)
        pool.cfg = cfg
    return out


def _serve(K, admit_every, uniforms=True):
    cfg = QuadratureConfig(**FIELDS, sync_every=K, admit_every=admit_every)
    eng = engine.VegasBatchEngine(cfg, devices=CPU,
                                  uniforms=pool_uniforms(cfg) if uniforms else None)
    sched = BatchScheduler(cfg, engine=eng)
    return sorted(sched.serve(_requests()), key=lambda r: r.req_id), sched


@pytest.fixture(scope="module")
def port():
    return {(K, adm): _serve(K, adm) for K in KS for adm in ADMIT}


@pytest.fixture(scope="module")
def own():
    """The port's own generator at K = 1, 4 and 16."""
    return {(K, adm): _serve(K, adm, uniforms=False) for K in (1, 4, 16) for adm in ADMIT}


# --- (a) the scheduler --------------------------------------------------------


@pytest.mark.parametrize("admit_every", ADMIT)
@pytest.mark.parametrize("K", KS)
def test_scheduler_matches_jax_scheduler(reference, port, K, admit_every):
    results, sched = port[K, admit_every]
    ref, ref_stats = reference[K, admit_every]
    assert {k: sched.last_stats[k] for k in ("dispatches", "iterations")} == {
        k: ref_stats[k] for k in ("dispatches", "iterations")}
    assert [r.req_id for r in results] == [r.req_id for r in ref]
    for got, want in zip(results, ref):
        assert _fields(got) == _fields(want), (got, want)
        np.testing.assert_allclose(got.integral, want.integral, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got.error, want.error, rtol=1e-9, atol=0)


def test_fleet_finishes_at_different_iterations(port):
    """The striped tolerances exercise the pool: slots end converged and
    at the cap, at different iterations, with admissions mid-flight."""
    for (K, adm), (results, sched) in port.items():
        assert {r.status for r in results} == {"converged", "max_iters"}, (K, adm)
        assert len({r.iterations for r in results}) > 2, (K, adm)
        assert len({r.admitted_at for r in results}) > 2, (K, adm)
        if K > 1:
            assert sched.last_stats["iterations"] > sched.last_stats["dispatches"]


# --- (b) run against the JAX run ------------------------------------------------


def _fleet(pool, admit):
    state = pool.init()
    thetas = _thetas()
    for i, (slot, (rel_tol, abs_tol)) in enumerate(LAYOUT.items()):
        state = admit(state, slot, thetas[i], rel_tol, abs_tol)
    return state


def _dispatches(pool, state):
    """Every dispatch of the fleet, released as the scheduler does."""
    runs, tick = [], 0
    while True:
        live = np.asarray(state.occupied) & ~np.asarray(state.done)
        if not live.any():
            return runs
        state, ms, executed, _ = pool.run(state, RUN_K, tick)
        ms = {k: np.asarray(v) for k, v in ms.items()}
        executed = np.asarray(executed)
        k = int(executed.sum())
        runs.append((ms, executed))
        tick += k
        for s in np.flatnonzero(ms["done"][k - 1] & ms["occupied"][k - 1]):
            state = pool.release(state, int(s))


def test_run_matches_jax_run_where_a_slot_finishes_mid_dispatch(jax_pools):
    cfg = QuadratureConfig(**FIELDS, sync_every=RUN_K)
    pool = engine.VegasBatchEngine(cfg, devices=CPU, uniforms=pool_uniforms(cfg))
    runs = _dispatches(pool, _fleet(pool, pool.admit))
    jpool = jax_pools[RUN_K]
    ref = _dispatches(jpool, _fleet(jpool, jpool.admit))
    assert len(runs) == len(ref)
    for (ms, executed), (jms, jexecuted) in zip(runs, ref):
        assert executed.tolist() == jexecuted.tolist()
        # at a dispatch's first iteration every occupied slot is live (the
        # finished ones were released)
        finished = np.zeros(FIELDS["batch_slots"], bool)
        for t in range(int(executed.sum())):
            live = ms["occupied"][t] & ~finished
            finished = ms["done"][t]
            for key in ("done", "occupied"):
                assert ms[key][t].tolist() == jms[key][t].tolist(), (key, t)
            for key in ("it", "converged", "nonfinite"):
                assert ms[key][t][live].tolist() == jms[key][t][live].tolist(), (key, t)
            np.testing.assert_allclose(ms["integral"][t][live], jms["integral"][t][live],
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(ms["error"][t][live], jms["error"][t][live],
                                       rtol=1e-9, atol=0)
    ms, executed = runs[1]
    assert executed.tolist() == [True, True, False, False]
    assert ms["done"][1].tolist() == [False, False, True, False]
    assert ms["converged"][1][2] and ms["it"][1][2] == 6
    assert pool.host_reads == len(runs)
    assert pool.landed_waits == sum(int(e.sum()) for _, e in runs)


# --- (c) the port's own generator ----------------------------------------------


@pytest.mark.parametrize("admit_every", ADMIT)
def test_own_generator_bit_equal_at_every_sync_every(own, admit_every):
    runs = {K: [_tuple(r) for r in own[K, admit_every][0]] for K in (1, 4, 16)}
    for K, got in runs.items():
        assert got == runs[1], (K, [(a, b) for a, b in zip(got, runs[1]) if a != b][:2])
    assert len({t[4] for t in runs[1]}) > 1


# --- (d) reads, waits, nothing past a finish -----------------------------------


@pytest.mark.parametrize("K", (1, 4, 16))
def test_one_read_per_dispatch_one_wait_per_iteration(own, K):
    for adm in ADMIT:
        sched = own[K, adm][1]
        eng, stats = sched.engine, sched.last_stats
        assert eng.host_reads == stats["dispatches"], (K, adm)
        assert eng.landed_waits == stats["iterations"], (K, adm)
        if K > 1:
            assert stats["iterations"] > stats["dispatches"]


def _counted_sums(monkeypatch):
    calls = []
    sums = engine.vegas_sums
    monkeypatch.setattr(engine, "vegas_sums", lambda *a: calls.append(1) or sums(*a))
    return calls


def test_one_sums_call_per_executed_iteration(monkeypatch):
    calls = _counted_sums(monkeypatch)
    results, sched = _serve(4, 1, uniforms=False)
    assert len(calls) == sched.last_stats["iterations"] == sched.engine.landed_waits


def _one_fast_slot(K):
    """The (b) fleet on the port's generator: slot 2 finishes at its sixth
    iteration."""
    pool = engine.VegasBatchEngine(QuadratureConfig(**FIELDS, sync_every=K), devices=CPU)
    return pool, _fleet(pool, pool.admit)


@pytest.mark.parametrize("K", (8, 16))
def test_nothing_is_enqueued_past_a_finish(monkeypatch, K):
    """A K dispatch stops at the iteration in which slot 2 finishes, with
    one sums call an iteration, and leaves the pool byte for byte as six
    K = 1 dispatches do."""
    calls = _counted_sums(monkeypatch)
    pool, state = _one_fast_slot(K)
    state, ms, executed, moved = pool.run(state, K, 0)
    assert executed.tolist() == [True] * 6 + [False] * (K - 6)
    assert ms["done"][5].tolist() == [False, False, True, False] and not ms["done"][4].any()
    assert len(calls) == 6 and pool.host_reads == 1 and pool.landed_waits == 6
    assert moved.shape == (K, 0, 2)
    one, state1 = _one_fast_slot(1)
    for _ in range(6):
        state1 = one.run(state1, 1, 0)[0]
    assert one.host_reads == one.landed_waits == 6
    a, b = one.to_host(state1), pool.to_host(state)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), key


def test_run_on_an_empty_pool_reads_nothing(monkeypatch):
    calls = _counted_sums(monkeypatch)
    pool = engine.VegasBatchEngine(QuadratureConfig(**FIELDS, sync_every=4), devices=CPU)
    state, ms, executed, moved = pool.run(pool.init(), 3, 0)
    assert executed.tolist() == [True, True, True, False]
    assert pool.host_reads == pool.landed_waits == 0 and not calls
    assert not ms["occupied"].any() and moved.shape == (4, 0, 2)


# --- (e) the float32 decision ---------------------------------------------------

# (integral, error, rel_tol, abs_tol, n_acc): float32(1e-3) is above 1e-3,
# so a float64 budget of 1e-3 refuses the error the float32 budget accepts
F32_CASE = (1.0, float(np.float32(1e-3)), 1e-3, 0.0, 2)


def _reference_converged(integral, error, rel_tol, abs_tol, n_acc, dtype):
    """``src/repro/mc/engine.py``'s pool decision, in ``dtype``."""
    budget = jnp.maximum(jnp.asarray(abs_tol, dtype), jnp.abs(jnp.asarray(integral, dtype))
                         * jnp.asarray(rel_tol, dtype))
    return bool((jnp.asarray(error, dtype) <= budget) & (n_acc >= J_MIN_ACCUMULATED))


def _float64_host_converged(integral, error, rel_tol, abs_tol, n_acc):
    """The pool's host decision before its dispatch was fused: float64."""
    budget = np.maximum(np.float64(abs_tol), np.abs(np.float64(integral)) * np.float64(rel_tol))
    return bool(error <= budget and n_acc >= engine.MIN_ACCUMULATED)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_slot_decisions_in_the_state_dtype(dtype):
    integral, error, rel_tol, abs_tol, n_acc = F32_CASE
    def f(v):
        return torch.tensor([v], dtype=getattr(torch, dtype))

    def flag(v):
        return torch.tensor([v])

    converged, done = engine.slot_decisions(
        f(integral), f(error), flag(False), f(rel_tol), f(abs_tol),
        flag(n_acc >= engine.MIN_ACCUMULATED), flag(False))
    want = _reference_converged(integral, error, rel_tol, abs_tol, n_acc, getattr(jnp, dtype))
    assert bool(converged) == bool(done) == want
    # float32 repairs what the float64 host budget decided: the two differ
    assert want == (dtype == "float32")
    assert _float64_host_converged(integral, error, rel_tol, abs_tol, n_acc) is False
    # the caps and the non-finite flag end a slot whatever its error
    for accumulated, capped, nonfinite in [(False, True, False), (False, False, True)]:
        converged, done = engine.slot_decisions(
            f(integral), f(1.0), flag(nonfinite), f(rel_tol), f(abs_tol), flag(accumulated),
            flag(capped))
        assert not bool(converged) and bool(done)


def test_float32_pool_converges_where_a_float64_budget_would_not():
    """Through ``run``: an iterate that reports the case's integral and
    error; the float32 pool's device decision converges the slot."""
    integral, error, rel_tol, abs_tol, n_acc = F32_CASE
    cfg = QuadratureConfig(**{**FIELDS, "dtype": "float32"}, sync_every=4)
    pool = engine.VegasBatchEngine(cfg, devices=CPU)

    def iterate(sub, theta):
        P = len(sub.it)
        new = dataclasses.replace(sub, it=sub.it + 1, n_acc=np.full(P, n_acc),
                                  n_evals=sub.n_evals + cfg.mc_samples)
        return new, {"integral": torch.full((P,), integral, dtype=torch.float32),
                     "error": torch.full((P,), error, dtype=torch.float32),
                     "nonfinite": torch.zeros(P, dtype=torch.bool)}

    pool._iterate = iterate
    state = pool.admit(pool.init(), 1, _thetas()[0], rel_tol=rel_tol, abs_tol=abs_tol)
    state, ms, executed, _ = pool.run(state, 4, 0)
    assert executed.tolist() == [True, False, False, False]
    assert ms["converged"][0].tolist() == ms["done"][0].tolist() == [False, True, False, False]
    assert ms["error"][0][1] == error and ms["integral"][0][1] == integral
    assert not _float64_host_converged(integral, error, rel_tol, abs_tol, n_acc)
