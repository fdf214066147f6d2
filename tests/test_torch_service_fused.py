"""The batch service's fused dispatch on the CPU, against the JAX service.

``repro_torch.service.batch_engine.BatchEngine.run`` runs up to
``sync_every`` iterations with one host read, as the JAX engine's
``lax.scan`` over ``lax.cond`` does.  The JAX service runs in a subprocess
with four forced host devices (one engine compiled a ``sync_every`` and
device count, shared by every run of this file), the port on ``["cpu"]``
and ``["cpu"] * 4``:

- (a) the scheduler at K = ``sync_every`` 1, 4 and 16 and ``admit_every``
  1 and 4, on one and four ranks, over striped easy and hard tolerances
  (slots migrate; one request is evicted): the port's results are the same
  bit for bit at every K and rank count, and equal the JAX service's at the
  same K, ``admit_every`` and device count (status, iterations,
  ``n_evals``, ``admitted_at``, ``finished_at``, and ``last_stats``'
  dispatches, iterations and migrations; the integral within rtol 1e-12 and
  the error within 1e-12 of |integral|, the bars of
  tests/test_torch_service.py);
- (b) ``run`` against the JAX engine's ``run``, dispatch by dispatch, on a
  four-rank fleet whose first dispatch ends in an iteration where a slot
  finishes and the round then moves a problem: ``executed``, ``moved`` and
  each executed row of ``done``, ``occupied`` and ``window``, and of ``it``
  and ``n_active`` at the slots live in that iteration (the JAX engine
  reports every slot there; the port zeros where no slot ran);
- (c) a dispatch whose first iteration finishes a slot enqueues nothing
  past it: one rule call a live rank, and the state byte for byte a
  K = 1 dispatch's, at K = 2, 8 and 16;
- (d) one host read per dispatch, and one wait on a landed row of
  decisions per iteration.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.service import BatchEngine, BatchScheduler, QuadRequest
from repro_torch.service.sharded_selftest import tuples

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = get_param("genz_gaussian")
FIELDS = dict(d=3, integrand="genz_gaussian", rel_tol=1e-8, capacity=1 << 11, batch_slots=8,
              max_iters=120)
TOLS = (1e-3, 1e-8)  # rel_tol of even and odd request indices
N_REQUESTS = 16
KS = (1, 4, 16)
ADMIT = (1, 4)
RANKS = (1, 4)
# (b): slot -> rel_tol.  Rank 2 is empty, so slot 3's problem moves to it
# in the first iteration; slot 6 (rank 3) finishes at the sixth, and the
# round after it moves a problem into rank 3, now empty.
LAYOUT = {0: 1e-8, 1: 1e-8, 2: 1e-8, 3: 1e-7, 6: 1e-3}
RUN_K = 16


def _thetas():
    rng = np.random.default_rng(2)
    return [FAMILY.sample_theta(FIELDS["d"], rng) for _ in range(N_REQUESTS)]


def _requests():
    return [QuadRequest(req_id=i, theta=t, rel_tol=TOLS[i % 2]) for i, t in enumerate(_thetas())]


_REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.core.config import QuadratureConfig
from repro.core.integrands import get_param
from repro.service import BatchEngine, BatchScheduler, QuadRequest
spec = json.loads(sys.argv[1])
family = get_param("genz_gaussian")
thetas = [{k: np.asarray(v) for k, v in th.items()} for th in spec["thetas"]]
out = {"serve": {}, "runs": []}
for K in spec["ks"]:
    for n in spec["ranks"]:
        cfg = QuadratureConfig(**spec["fields"], sync_every=K)
        eng = BatchEngine(cfg, family, devices=jax.devices()[:n])
        for adm in spec["admit"]:
            # the scheduler reads admit_every from its engine's cfg; the
            # compiled dispatch does not depend on it
            eng.cfg = dataclasses.replace(cfg, admit_every=adm)
            sched = BatchScheduler(eng.cfg, engine=eng)
            reqs = [QuadRequest(req_id=i, theta=t, rel_tol=spec["tols"][i % 2])
                    for i, t in enumerate(thetas)]
            res = sorted(sched.serve(reqs), key=lambda r: r.req_id)
            out["serve"]["%d-%d-%d" % (K, adm, n)] = dict(
                results=[[r.req_id, r.integral, r.error, r.status, r.iterations, r.n_evals,
                          r.admitted_at, r.finished_at] for r in res],
                stats={k: sched.last_stats[k] for k in ("dispatches", "iterations", "migrations")})
        if K == spec["run_k"] and n == 4:
            eng.cfg = cfg
            state = eng.init()
            for i, (slot, tol) in enumerate(spec["layout"]):
                state = eng.admit(state, slot, thetas[i], rel_tol=tol)
            tick = 0
            while bool(np.any(np.asarray(state.occupied) & ~np.asarray(state.done))):
                state, ms, executed, moved = eng.run(state, K, tick)
                ms = {k: np.asarray(v) for k, v in ms.items()}
                executed = np.asarray(executed)
                k = int(executed.sum())
                out["runs"].append(dict(
                    executed=executed.tolist(), moved=np.asarray(moved).tolist(),
                    **{key: ms[key].tolist()
                       for key in ("done", "occupied", "window", "it", "n_active")}))
                tick += k
                for s in np.flatnonzero(ms["done"][k - 1]):
                    state = eng.release(state, int(s))
print("RESULT_JSON:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    spec = dict(
        fields=FIELDS, tols=TOLS, ks=KS, admit=ADMIT, ranks=RANKS, run_k=RUN_K,
        layout=list(LAYOUT.items()),
        thetas=[{k: np.asarray(v).tolist() for k, v in th.items()} for th in _thetas()],
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(spec)],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT_JSON:")]
    return json.loads(line[-1][len("RESULT_JSON:"):])


def _serve(K, admit_every, ranks):
    cfg = QuadratureConfig(**FIELDS, sync_every=K, admit_every=admit_every)
    sched = BatchScheduler(cfg, FAMILY, devices=["cpu"] * ranks)
    results = sorted(sched.serve(_requests()), key=lambda r: r.req_id)
    return results, sched


@pytest.fixture(scope="module")
def port():
    return {(K, adm, n): _serve(K, adm, n) for K in KS for adm in ADMIT for n in RANKS}


@pytest.mark.parametrize("admit_every", ADMIT)
def test_results_equal_at_every_sync_every_and_rank_count(port, admit_every):
    runs = {(K, n): tuples(port[K, admit_every, n][0]) for K in KS for n in RANKS}
    want = runs[1, 1]
    for key, got in runs.items():
        assert got == want, (key, [(a, b) for a, b in zip(got, want) if a != b][:2])
    statuses = {t[3] for t in want}
    assert statuses == {"converged", "capacity"}, statuses
    assert len({t[6] for t in want}) > 1, "no mid-flight admission"
    assert port[1, admit_every, 4][1].last_stats["migrations"] > 0


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("admit_every", ADMIT)
@pytest.mark.parametrize("K", KS)
def test_service_matches_jax_service(reference, port, K, admit_every, ranks):
    results, sched = port[K, admit_every, ranks]
    ref = reference["serve"][f"{K}-{admit_every}-{ranks}"]
    assert {k: sched.last_stats[k] for k in ref["stats"]} == ref["stats"]
    assert [r.req_id for r in results] == [r[0] for r in ref["results"]]
    for got, (_, integral, error, status, iterations, n_evals, admitted, finished) in zip(
            results, ref["results"]):
        assert (got.status, got.iterations, got.n_evals, got.admitted_at, got.finished_at) == (
            status, iterations, n_evals, admitted, finished), (got, ref)
        assert abs(got.integral - integral) <= 1e-12 * abs(integral), (got, integral)
        assert abs(got.error - error) <= 1e-12 * abs(integral), (got, error)


@pytest.mark.parametrize("K", KS)
def test_one_host_read_per_dispatch(port, K):
    """(d) the engine counts its reads: one a dispatch, whatever it runs;
    and its waits on a landed row of decisions: one an iteration."""
    for adm in ADMIT:
        for n in RANKS:
            _, sched = port[K, adm, n]
            eng, stats = sched.engine, sched.last_stats
            assert eng.host_reads == stats["dispatches"], (K, adm, n)
            assert eng.landed_waits == stats["iterations"], (K, adm, n)
            if K > 1:
                assert stats["iterations"] > stats["dispatches"]


def _fleet(K, ranks=4):
    eng = BatchEngine(QuadratureConfig(**FIELDS, sync_every=K), FAMILY, devices=["cpu"] * ranks)
    state = eng.init()
    thetas = _thetas()
    for i, (slot, tol) in enumerate(LAYOUT.items()):
        state = eng.admit(state, slot, thetas[i], rel_tol=tol)
    return eng, state


def test_run_matches_jax_run_where_a_flip_meets_a_move(reference):
    """(b) every dispatch of the fleet, released as the scheduler does, with
    no admission: the first ends at the iteration where slot 6 finishes,
    whose round, planned from the masks after the flip, moves slot 1 into
    rank 3."""
    eng, state = _fleet(RUN_K)
    tick = 0
    runs = []
    while (state.occupied & ~state.done).any():
        state, ms, executed, moved = eng.run(state, RUN_K, tick)
        k = int(executed.sum())
        runs.append((ms, executed, moved))
        tick += k
        for s in np.flatnonzero(ms["done"][k - 1]):
            state = eng.release(state, int(s))
    assert len(runs) == len(reference["runs"])
    for (ms, executed, moved), ref in zip(runs, reference["runs"]):
        k = int(executed.sum())
        assert executed.tolist() == ref["executed"]
        assert moved.tolist() == ref["moved"]
        for key in ("done", "occupied", "window"):
            assert ms[key].tolist() == ref[key], key
        for t in range(k):
            live = ms["occupied"][t] & ~(ms["done"][t - 1] if t else np.zeros_like(ms["done"][t]))
            for key in ("it", "n_active"):
                assert ms[key][t][live].tolist() == np.asarray(ref[key][t])[live].tolist(), key
    ms, executed, moved = runs[0]
    k = int(executed.sum())
    assert k > 2 and ms["done"][k - 1][6]
    # records by receiving rank: rank 2 takes slot 3 first, rank 3 slot 1 last
    assert moved[0].tolist()[2] == [3, 4] and moved[k - 1].tolist()[3] == [1, 7]
    assert eng.host_reads == len(runs)


@pytest.mark.parametrize("K", (2, 8, 16))
def test_nothing_is_enqueued_past_a_finish(K):
    """(c) slot 6, at abs_tol 1, finishes in the first iteration: a K
    dispatch stops there, with one rule call a rank with a live slot and
    the round after the flip, and leaves the state byte for byte as a
    K = 1 dispatch does."""
    states = {}
    for k in (1, K):
        eng = BatchEngine(QuadratureConfig(**FIELDS, sync_every=k), FAMILY, devices=["cpu"] * 4)
        calls = []
        eval_batch = eng._rule.eval_batch
        eng._rule.eval_batch = lambda *a, **kw: calls.append(1) or eval_batch(*a, **kw)
        state = eng.init()
        thetas = _thetas()
        for i, (slot, tol) in enumerate(LAYOUT.items()):
            state = eng.admit(state, slot, thetas[i], rel_tol=tol, abs_tol=1.0 if slot == 6 else None)
        state, ms, executed, moved = eng.run(state, k, 0)
        assert executed.tolist() == [True] + [False] * (k - 1)
        assert ms["done"][0].tolist() == [s == 6 for s in range(8)]
        assert sorted(map(tuple, moved[0].tolist())) == [(-1, -1)] * 3 + [(3, 4)]
        assert (moved[1:] == -1).all()
        assert len(calls) == 3 and eng.eval_steps.tolist() == [1, 1, 0, 1]
        assert eng.host_reads == eng.landed_waits == 1
        states[k] = eng.to_host(state)
    for key, a in states[1].items():
        b = states[K][key]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key


def test_step_is_one_iteration_without_migration():
    """``step`` runs one iteration, reads once and moves nothing (the JAX
    engine's ``step``)."""
    eng, state = _fleet(4)
    occupied = state.occupied.copy()
    state, row = eng.step(state)
    assert eng.host_reads == 1 and eng.eval_steps.tolist() == [1, 1, 0, 1]
    assert (state.occupied == occupied).all() and row["occupied"].tolist() == occupied.tolist()
    assert row["it"][occupied].tolist() == [1] * int(occupied.sum())
    assert row["window"] == 256


def test_run_on_an_empty_fleet_reads_nothing():
    eng = BatchEngine(QuadratureConfig(**FIELDS, sync_every=4), FAMILY, devices=["cpu"] * 2)
    state, ms, executed, moved = eng.run(eng.init(), 3, 0)
    assert executed.tolist() == [True, True, True, False]
    assert eng.host_reads == 0 and not ms["occupied"].any()
    assert (moved == -1).all() and moved.shape == (4, 2, 2)
