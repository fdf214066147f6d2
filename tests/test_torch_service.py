"""The port's batch service on the CPU, held to two references.

The cases are those of tests/test_service.py (its ``_cfg``: d = 3,
capacity 2^11, 4 slots, the same seeds), run through the port's
``integrate_batch`` / ``serve`` with ``devices=["cpu"]``:

- against the port's own ``integrate`` on each request's theta and
  tolerance: the integral, error, iterations and ``n_evals`` are equal,
  bit for bit;
- against the JAX package's ``integrate_batch`` in the same process (x64,
  one CPU device): the same results in the same order with the same status,
  iterations, ``n_evals``, ``admitted_at`` and ``finished_at``; the integral
  within rtol 1e-12, and the error within 1e-12 of |integral| (the error
  estimate is a difference of two rules' estimates, so the last-bit
  differences of XLA's and PyTorch's arithmetic grow in it relative to its
  own size; ROADMAP, "Known differences").
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.core.integrands import get_param as jget_param
from repro.service import QuadRequest as JRequest
from repro.service import integrate_batch as jintegrate_batch
from repro.service import serve as jserve
from repro_torch.core import adaptive as tad
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param, to_spec
from repro_torch.service import (
    BatchEngine,
    BatchScheduler,
    QuadRequest,
    integrate_batch,
    serve,
)
from repro_torch.service.scheduler import decode_request, encode_request, make_engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = get_param("genz_gaussian")
D = 3
CPU = ["cpu"]


def _fields(**kw):
    base = dict(d=D, integrand="genz_gaussian", rel_tol=1e-6, capacity=1 << 11,
                batch_slots=4, max_iters=120)
    base.update(kw)
    return base


def _thetas(n, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return [FAMILY.sample_theta(d, rng) for _ in range(n)]


def _serial(fields, theta, rel_tol=None):
    """The port's integrate on one request: the family spec carries theta."""
    cfg = QuadratureConfig(**fields)
    cfg = dataclasses.replace(cfg, integrand=to_spec(FAMILY, theta),
                              rel_tol=cfg.rel_tol if rel_tol is None else rel_tol)
    return tad.integrate(cfg, device="cpu")


def _check_serial(fields, thetas, results, rel_tols=None):
    """Each converged or capped result equals the port's integrate on its
    theta and tolerance, bit for bit."""
    for res in results:
        tol = None if rel_tols is None else rel_tols[res.req_id]
        serial = _serial(fields, thetas[res.req_id], rel_tol=tol)
        assert (res.status, res.integral, res.error, res.iterations, res.n_evals) == (
            serial.status, serial.integral, serial.error, serial.iterations,
            serial.n_evals), (res, serial)


def _check_reference(got, ref):
    """The port's results against the JAX service's, request by request."""
    assert [r.req_id for r in got] == [r.req_id for r in ref]
    for g, r in zip(got, ref):
        assert (g.status, g.iterations, g.n_evals, g.admitted_at, g.finished_at) == (
            r.status, r.iterations, r.n_evals, r.admitted_at, r.finished_at), (g, r)
        assert abs(g.integral - r.integral) <= 1e-12 * abs(r.integral), (g, r)
        assert abs(g.error - r.error) <= 1e-12 * abs(r.integral), (g, r)


def _both(fields, thetas, rel_tol=None, **kw):
    """(port, JAX) integrate_batch on the same problems."""
    got = integrate_batch(QuadratureConfig(**fields), thetas, rel_tol=rel_tol,
                          devices=CPU, **kw)
    ref = jintegrate_batch(JConfig(**fields), thetas, rel_tol=rel_tol, **kw)
    _check_reference(got, ref)
    return got


def test_batch_matches_serial_and_exact_with_midflight_admission():
    fields = _fields()
    thetas = _thetas(10)
    results = _both(fields, thetas)
    assert [r.req_id for r in results] == list(range(10))
    assert len({r.admitted_at for r in results}) > 1, "no mid-flight admission"
    _check_serial(fields, thetas, results)
    for theta, res in zip(thetas, results):
        assert res.status == "converged"
        exact = FAMILY.exact(D, theta)
        budget = max(1e-16, abs(exact) * 1e-6)
        assert res.error <= budget
        assert abs(res.integral - exact) <= 10 * max(res.error, budget)


def test_midflight_slot_is_bitwise_identical_to_serial():
    fields = _fields(batch_slots=2)
    thetas = _thetas(5, seed=7)
    results = _both(fields, thetas)
    late = [r for r in results if r.admitted_at > 0]
    assert late, "no slot was refilled mid-flight"
    _check_serial(fields, thetas, results)


def test_max_iters_parity_with_serial():
    fields = _fields(batch_slots=2, max_iters=6, rel_tol=1e-14)
    theta = _thetas(1, seed=29)[0]
    (res,) = _both(fields, [theta])
    assert res.status == "max_iters"
    _check_serial(fields, [theta], [res])


@pytest.mark.parametrize("classifier", ["robust", "aggressive"])
def test_per_request_tolerances(classifier):
    """Per-request tolerances reach both classifiers (the aggressive one's
    local-prune term reads rel_tol directly)."""
    fields = _fields(batch_slots=2, classifier=classifier, rel_tol=1e-8)
    theta = _thetas(1, seed=3)[0]
    loose, tight = _both(fields, [theta, theta], rel_tol=[1e-3, 1e-6])
    assert loose.status == tight.status == "converged"
    assert loose.iterations < tight.iterations and loose.n_evals < tight.n_evals
    _check_serial(fields, [theta, theta], [loose, tight], [1e-3, 1e-6])


def test_stacked_theta_dict():
    fields = _fields(batch_slots=3)
    thetas = _thetas(3, seed=5)
    stacked = {k: np.stack([t[k] for t in thetas]) for k in FAMILY.theta_fields}
    a = integrate_batch(QuadratureConfig(**fields), thetas, devices=CPU)
    b = _both(fields, stacked)
    assert [r.integral for r in a] == [r.integral for r in b]
    _check_serial(fields, thetas, b)


def test_serve_streams_in_convergence_order():
    fields = _fields(batch_slots=4, rel_tol=1e-5)
    thetas = _thetas(6, seed=11)
    reqs = (QuadRequest(req_id=i, theta=t) for i, t in enumerate(thetas))
    seen = list(serve(QuadratureConfig(**fields), reqs, FAMILY, devices=CPU))
    ref = list(jserve(JConfig(**fields), (JRequest(req_id=i, theta=t)
                                          for i, t in enumerate(thetas)), jget_param(FAMILY.name)))
    _check_reference(seen, ref)  # the same convergence order
    assert sorted(r.req_id for r in seen) == list(range(6))
    assert [r.finished_at for r in seen] == sorted(r.finished_at for r in seen)
    assert all(r.finished_at >= r.admitted_at for r in seen)
    _check_serial(fields, thetas, seen)


def test_admit_every_batches_admissions():
    fields = _fields(batch_slots=2, admit_every=5, rel_tol=1e-3)
    thetas, tols = _thetas(6, seed=13), [1e-6] + [1e-3] * 5
    results = _both(fields, thetas, rel_tol=tols)
    _check_serial(fields, thetas, results, tols)
    assert all(r.status == "converged" for r in results)
    anchor_end = results[0].finished_at
    inflight = [r for r in results[1:] if 0 < r.admitted_at <= anchor_end]
    assert inflight, "no admission while the anchor request was in flight"
    assert all(r.admitted_at % 5 == 0 for r in inflight)


def test_capacity_overflow_is_evicted_and_queue_drains():
    fields = _fields(capacity=1 << 7, batch_slots=2, rel_tol=1e-4, max_iters=80)
    hard = _thetas(1, seed=3)[0]
    easy = _thetas(4, seed=17)
    results = _both(fields, [hard] + easy, rel_tol=[1e-8] + [1e-4] * 4)
    assert results[0].status == "capacity"
    assert all(r.status == "converged" for r in results[1:])
    exact = FAMILY.exact(D, hard)
    assert abs(results[0].integral - exact) <= 0.1 * abs(exact)
    # the evicted estimate is the serial driver's at the same evaluate step:
    # integrate cut after that step (one more advance, which it counts)
    evicted = results[0]
    serial = _serial(dict(fields, max_iters=evicted.iterations + 1), hard, rel_tol=1e-8)
    assert serial.status == "capacity"
    assert (evicted.integral, evicted.error, evicted.n_evals) == (
        serial.integral, serial.error, serial.n_evals)
    assert serial.iterations == evicted.iterations + 1
    _check_serial(fields, [hard] + easy, results[1:], [1e-8] + [1e-4] * 4)


def test_nonfinite_slot_is_quarantined():
    """A NaN theta poisons its own slot only: it ends "nonfinite" with its
    regions quarantined, and the other slots keep their bits."""
    fields = _fields(batch_slots=2)
    thetas = _thetas(4)
    thetas[1] = {k: v.copy() for k, v in thetas[1].items()}
    thetas[1]["a"][0] = np.nan
    results = _both(fields, thetas)
    assert [r.status for r in results] == ["converged", "nonfinite", "converged", "converged"]
    assert results[1].integral == 0.0 and results[1].error == 0.0
    sched = BatchScheduler(QuadratureConfig(**fields), devices=CPU)
    list(sched.serve([QuadRequest(req_id=i, theta=t) for i, t in enumerate(thetas)]))
    assert sched.last_stats["quarantines"] == 1
    _check_serial(fields, thetas, [r for r in results if r.status == "converged"])


def test_max_evals_deadline_evicts_at_the_dispatch_boundary():
    fields = _fields(batch_slots=2, rel_tol=1e-9)
    thetas = _thetas(4, seed=19)
    budget = 2e4
    got = list(serve(QuadratureConfig(**fields),
                     [QuadRequest(req_id=i, theta=t, max_evals=budget) for i, t in enumerate(thetas)],
                     FAMILY, devices=CPU))
    ref = list(jserve(JConfig(**fields),
                      [JRequest(req_id=i, theta=t, max_evals=budget) for i, t in enumerate(thetas)],
                      jget_param(FAMILY.name)))
    _check_reference(got, ref)
    assert {r.status for r in got} == {"deadline"}
    assert all(r.n_evals > budget for r in got)
    # the partial estimate is the serial driver's cut after as many
    # evaluate steps
    for res in got:
        serial = _serial(dict(fields, max_iters=res.iterations), thetas[res.req_id])
        assert serial.status == "max_iters"
        assert (res.integral, res.error, res.iterations, res.n_evals) == (
            serial.integral, serial.error, serial.iterations, serial.n_evals)


def test_on_tick_sees_every_dispatch_boundary():
    """on_tick(it, state, slot_req) runs after every dispatch, with the
    iteration count and the slot map; returning None keeps the state."""
    ticks = []
    sched = BatchScheduler(QuadratureConfig(**_fields(batch_slots=2)), devices=CPU,
                           on_tick=lambda it, state, slots: ticks.append(
                               (it, state.n_slots, [r and r.req_id for r in slots])))
    results = list(sched.serve([QuadRequest(req_id=i, theta=t)
                                for i, t in enumerate(_thetas(3, seed=2))]))
    assert len(ticks) == sched.last_stats["dispatches"] > 1
    assert [t[0] for t in ticks] == sorted(t[0] for t in ticks)
    assert ticks[-1][0] == sched.last_stats["iterations"] == max(r.finished_at for r in results)
    assert all(n == 2 for _, n, _ in ticks) and ticks[-1][2] == [None, None]


def test_scheduler_empty_request_stream():
    assert list(BatchScheduler(QuadratureConfig(**_fields()), devices=CPU).serve([])) == []


def test_encode_decode_round_trip():
    theta = _thetas(1, seed=41)[0]
    theta = {k: v * (1 + 1e-15) for k, v in theta.items()}  # bits json must keep
    engine = BatchEngine(QuadratureConfig(**_fields()), devices=CPU)
    for req in (QuadRequest(req_id=7, theta=theta),
                QuadRequest(req_id=8, theta=theta, rel_tol=1e-5, abs_tol=1e-12,
                            deadline_s=2.5, max_evals=1e6)):
        back = decode_request(json.loads(json.dumps(encode_request(req))),
                              engine.theta_template)
        assert (back.req_id, back.rel_tol, back.abs_tol, back.deadline_s, back.max_evals) == (
            req.req_id, req.rel_tol, req.abs_tol, req.deadline_s, req.max_evals)
        for k in FAMILY.theta_fields:
            assert back.theta[k].shape == (D,)
            assert np.array_equal(back.theta[k], req.theta[k])


def test_engine_checks_theta_shape_and_slot():
    eng = BatchEngine(QuadratureConfig(**_fields()), devices=CPU)
    state = eng.init()
    with pytest.raises(ValueError, match="theta shape mismatch"):
        eng.admit(state, 0, {"a": np.zeros(D + 1), "u": np.zeros(D + 1)})
    for bad in (-1, 4):
        with pytest.raises(IndexError, match="out of range"):
            eng.admit(state, bad, _thetas(1)[0])
        with pytest.raises(IndexError, match="out of range"):
            eng.release(state, bad)


def test_engine_step_on_empty_fleet_is_noop():
    eng = BatchEngine(QuadratureConfig(**_fields()), devices=CPU)
    state, metrics = eng.step(eng.init())
    assert not metrics["done"].any() and not metrics["occupied"].any()
    assert int(metrics["n_active"].sum()) == 0


def test_run_stops_at_the_first_done_flip():
    """run() returns the JAX engine's shapes and stops after the iteration
    in which a slot finishes."""
    cfg = QuadratureConfig(**_fields(sync_every=16))
    eng = BatchEngine(cfg, devices=CPU)
    state = eng.init()
    for slot, theta in enumerate(_thetas(4)):
        state = eng.admit(state, slot, theta, rel_tol=1e-3 if slot == 2 else None)
    state, ms, executed, moved = eng.run(state, 16, 0)
    k = int(executed.sum())
    assert executed[:k].all() and not executed[k:].any() and 1 <= k < 16
    assert ms["done"].shape == (16, 4) and moved.shape == (16, 0, 2)
    assert ms["done"][k - 1][2] and ms["done"][k - 1].sum() == 1
    assert not ms["done"][: k - 1].any()


def test_vegas_pool_is_single_rank():
    """The VEGAS pool raises only when asked for several ranks."""
    cfg = QuadratureConfig(**_fields())
    with pytest.raises(ValueError, match="single-device"):
        make_engine(dataclasses.replace(cfg, backend="vegas"), devices=CPU * 2)
    with pytest.raises(ValueError, match="single-device"):
        make_engine(dataclasses.replace(cfg, backend="auto", d=9), devices=CPU * 2)
    assert make_engine(dataclasses.replace(cfg, backend="vegas"), devices=CPU).backend == "vegas"


def test_without_devices_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEngine(QuadratureConfig(**_fields()))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_quad", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


def test_cli_serves_on_cpu_ranks():
    proc = _cli("--device", "cpu", "--d", "2", "--n-requests", "8", "--batch-slots", "4",
                "--devices", "2", "--rel-tols", "1e-2,1e-7", "--validate")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[")]
    assert len(lines) == 8 and all("[converged]" in l and "true_rel_err=" in l for l in lines)
    assert "done: 8 problems" in proc.stdout


@pytest.mark.parametrize(
    "args", [["--use-kernel"], ["--no-interpret"]],
    ids=lambda a: a[0],
)
def test_cli_flags_of_other_slices_fail_clearly(args):
    # the telemetry flags are ported (tests/test_torch_cli.py); the JAX
    # CLI's Pallas flags stay out of scope and say so
    proc = _cli("--device", "cpu", *args)
    assert proc.returncode == 2 and "out of scope" in proc.stderr, proc.stderr[-500:]
