"""The port's fault tolerance on the CPU, held against the JAX package.

Counterparts of tests/test_faults.py (the same fleet: genz_gaussian, d=2,
capacity 2^9, 4 slots): the NaN wrapper and quarantine, slot corruption
re-routed, deadlines, crash and resume, the watchdog's retry, timeout and
rank loss, the restore fallbacks and the async write errors, run through
the port with ``devices=["cpu"]``.  Where a test compares values, the
port's fault-free and resumed fleets are held against the JAX
``BatchScheduler`` on the same requests: the same status, iterations,
``n_evals``, ``admitted_at`` and ``finished_at``, the integral within rtol
1e-12 and the error within 1e-12 of |integral| (ROADMAP, "Known
differences").  Among themselves the port's runs are bit for bit.

New parts of the port: ``to_host`` / ``place`` on both engines, a snapshot
that a later dispatch cannot change (the port's state is updated in place),
the watchdog's abandoned thread waking mid-run, and the GM evaluate's
sentinel route (what carries the poison on the card).
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.config import QuadratureConfig as JConfig
from repro.core.integrands import get_param as jget_param
from repro.service import BatchScheduler as JScheduler
from repro.service import QuadRequest as JRequest
from repro.service.faults import nan_family as jnan_family
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.adaptive import integrate
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.kernels import ops
from repro_torch.service import (
    BatchEngine,
    BatchScheduler,
    GracefulScheduler,
    QuadRequest,
    ServiceCheckpointer,
)
from repro_torch.service.faults import (
    NAN_SENTINEL,
    DeviceDown,
    DeviceLostError,
    SimulatedCrash,
    corrupt_slot,
    corrupt_slot_hook,
    crash_at,
    nan_family,
    poison_theta,
)
from repro_torch.mc.engine import VegasBatchEngine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = get_param("genz_gaussian")
CPU = ["cpu"]
# the watchdog's timeout in the hang tests: far above a genuine dispatch of
# these fleets on a loaded CPU (milliseconds), far below the hangs (4 s)
TIMEOUT_S = 1.5


def _fields(**kw):
    base = dict(d=2, integrand="genz_gaussian", rel_tol=1e-3, capacity=1 << 9,
                batch_slots=4, max_iters=60, sync_every=4)
    base.update(kw)
    return base


def _cfg(**kw):
    return QuadratureConfig(**_fields(**kw))


def _requests(n, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [QuadRequest(req_id=i, theta=FAMILY.sample_theta(2, rng), **kw) for i in range(n)]


def _vals(results):
    return {r.req_id: (r.integral.hex(), r.error.hex(), r.status, r.iterations, r.n_evals)
            for r in results}


def _full(results):
    return {r.req_id: _vals([r])[r.req_id] + (r.admitted_at, r.finished_at) for r in results}


def _jax(reqs, family=None, **kw):
    """The JAX service on the same requests (one CPU device), by req_id."""
    jfam = jget_param(FAMILY.name) if family is None else family
    jreqs = [JRequest(req_id=r.req_id, theta=r.theta, rel_tol=r.rel_tol, abs_tol=r.abs_tol)
             for r in reqs]
    return {r.req_id: r for r in JScheduler(JConfig(**_fields(**kw)), jfam).serve(jreqs)}


def _check_reference(got, ref):
    """The port's results against the JAX service's, request by request."""
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        assert (g.status, g.iterations, g.n_evals, g.admitted_at, g.finished_at) == (
            r.status, r.iterations, r.n_evals, r.admitted_at, r.finished_at), (g, r)
        assert abs(g.integral - r.integral) <= 1e-12 * abs(r.integral), (g, r)
        assert abs(g.error - r.error) <= 1e-12 * abs(r.integral), (g, r)


def _crash_then_resume(cfg, reqs, ckpt, crash_it, resume_devices=CPU, **kw):
    """(results before the crash, results after the resume)."""
    crashing = BatchScheduler(cfg, FAMILY, devices=kw.pop("devices", CPU), checkpointer=ckpt,
                              on_tick=crash_at(crash_it), **kw)
    pre = []
    with pytest.raises(SimulatedCrash):
        for r in crashing.serve(list(reqs)):
            pre.append(r)
    assert ckpt.latest_step() is not None
    resumed = BatchScheduler(cfg, FAMILY, devices=resume_devices, checkpointer=ckpt)
    return pre, list(resumed.serve(list(reqs), resume=True))


def _union(pre, post):
    got = {}
    for r in pre + post:
        t = _full([r])[r.req_id]
        assert got.setdefault(r.req_id, t) == t  # replays are bit-identical
    return got


# --- NaN injection and quarantine ---------------------------------------------


def test_serial_integrate_quarantines_nan_integrand():
    wrapped = nan_family(FAMILY)
    theta = poison_theta(FAMILY.sample_theta(2, np.random.default_rng(0)))
    res = integrate(_cfg(), integrand=lambda x: wrapped.fn(x, theta), device="cpu")
    assert res.status == "nonfinite"
    assert np.isfinite(res.integral) and np.isfinite(res.error)


def test_nan_wrapper_is_identity_for_healthy_theta():
    wrapped = nan_family(FAMILY)
    theta = FAMILY.sample_theta(2, np.random.default_rng(1))
    base = integrate(_cfg(), integrand=lambda x: FAMILY.fn(x, theta), device="cpu")
    via = integrate(_cfg(), integrand=lambda x: wrapped.fn(x, theta), device="cpu")
    assert base.integral.hex() == via.integral.hex()
    assert base.error.hex() == via.error.hex()
    assert base.status == via.status == "converged"


@pytest.mark.parametrize("name", ["genz_gaussian", "monomial"])
def test_gm_evaluate_sentinel_route(name):
    """The route the card takes: the family's ``fn`` left as it is, only
    ``nan_sentinel`` set.  Lanes of a poisoned theta column go NaN (monomial
    at x = 1 included, where NaN in theta would give pow(1, NaN) = 1), the
    other lanes keep their bits."""
    family = get_param(name)
    marked = dataclasses.replace(family, nan_sentinel=NAN_SENTINEL)
    rng = np.random.default_rng(4)
    d, lanes, slots = 3, 5, 4
    centers = torch.as_tensor(rng.uniform(0.1, 0.9, (slots * lanes, d)))
    centers[lanes:2 * lanes] = 0.5  # slot 1: corners at x = 1 on every axis
    halfw = torch.full((slots * lanes, d), 0.5, dtype=torch.float64)
    thetas = [family.sample_theta(d, rng) for _ in range(slots)]
    thetas[1] = poison_theta(thetas[1])
    cols = torch.as_tensor(np.stack(
        [np.concatenate([t[k] for k in family.theta_fields]) for t in thetas], 1))
    got = ops.genz_malik_eval(marked, centers, halfw, theta_cols=cols)
    clean = ops.genz_malik_eval(family, centers, halfw, theta_cols=cols)
    bad = torch.zeros(slots * lanes, dtype=torch.bool)
    bad[lanes:2 * lanes] = True
    for g, c in zip(got, clean):
        assert bool(torch.isnan(g[bad]).all())
        assert torch.equal(g[~bad], c[~bad])
    if name == "monomial":
        assert bool(torch.isfinite(clean[0][bad]).all())  # the poison is the route's


def test_cubature_fleet_quarantine_contains_poison():
    """One NaN slot does not change the healthy slots' bits and is collected
    nonfinite at once; the whole fleet matches the JAX service's."""
    reqs = _requests(4)
    base = _vals(BatchScheduler(_cfg(), FAMILY, devices=CPU).serve(list(reqs)))
    poisoned = reqs + [QuadRequest(req_id=99, theta=poison_theta(reqs[0].theta))]
    sched = BatchScheduler(_cfg(), nan_family(FAMILY), devices=CPU)
    results = {r.req_id: r for r in sched.serve(list(poisoned))}
    vals = _vals(results.values())
    assert vals.pop(99)[2] == "nonfinite"
    assert vals == base
    assert sched.last_stats["quarantines"] == 1
    _check_reference(results, _jax(poisoned, jnan_family(jget_param(FAMILY.name))))


def test_monomial_fleet_quarantines_poison():
    family = get_param("monomial")
    rng = np.random.default_rng(2)
    reqs = [QuadRequest(req_id=i, theta=family.sample_theta(2, rng)) for i in range(3)]
    reqs.append(QuadRequest(req_id=9, theta=poison_theta(reqs[0].theta)))
    cfg = _cfg(integrand="monomial")
    results = {r.req_id: r for r in BatchScheduler(cfg, nan_family(family), devices=CPU)
               .serve(list(reqs))}
    clean = _vals(BatchScheduler(cfg, family, devices=CPU).serve(reqs[:3]))
    assert results[9].status == "nonfinite"
    assert {k: v for k, v in _vals(results.values()).items() if k != 9} == clean


def test_vegas_fleet_quarantine():
    cfg = _cfg(backend="vegas", mc_samples=512, mc_max_iters=20)
    reqs = _requests(2, rel_tol=1e-2) + [
        QuadRequest(req_id=50,
                    theta=poison_theta(FAMILY.sample_theta(2, np.random.default_rng(5))))
    ]
    sched = BatchScheduler(cfg, nan_family(FAMILY), devices=CPU)
    by_id = {r.req_id: r for r in sched.serve(reqs)}
    assert by_id[50].status == "nonfinite"
    assert by_id[50].backend == "vegas"
    for i in (0, 1):
        assert by_id[i].status in ("converged", "max_iters")
        assert np.isfinite(by_id[i].integral)
    assert sched.last_stats["quarantines"] == 1


def test_slot_corruption_detected_and_rerouted():
    reqs = _requests(4)
    reqs[0] = dataclasses.replace(reqs[0], rel_tol=1e-7)
    base = _vals(BatchScheduler(_cfg(), FAMILY, devices=CPU).serve(list(reqs)))
    graceful = GracefulScheduler(_cfg(), FAMILY, devices=CPU,
                                 on_tick=corrupt_slot_hook(0, 1, req_id=0))
    results = {r.req_id: r for r in graceful.serve(list(reqs))}
    assert results[0].retried_from == "nonfinite"
    assert results[0].backend == "vegas"
    assert np.isfinite(results[0].integral)
    assert {k: v for k, v in _vals(results.values()).items() if k} == \
        {k: v for k, v in base.items() if k}


def test_corrupt_slot_poisons_the_slots_state_on_any_rank():
    eng = BatchEngine(_cfg(batch_slots=4), devices=CPU * 2)
    state = eng.init()
    for s, req in enumerate(_requests(4)):
        state = eng.admit(state, s, req.theta)
    state = corrupt_slot(state, 3)
    host = eng.to_host(state)
    assert np.isnan(host["regions/centers"][3]).all()
    assert np.isnan(host["regions/fin_integral"][3])
    assert np.isfinite(host["regions/centers"][:3]).all()
    pool = VegasBatchEngine(_cfg(backend="vegas"), devices=CPU)
    ps = corrupt_slot(pool.init(), 1)
    assert np.isnan(ps.mc.sum_wi[1].item()) and np.isnan(ps.mc.sum_wi2[1].item())
    with pytest.raises(TypeError):
        corrupt_slot(object(), 0)


# --- deadlines ----------------------------------------------------------------


def test_max_evals_deadline_evicts_with_partial():
    reqs = _requests(4)
    reqs[0] = dataclasses.replace(reqs[0], rel_tol=1e-12, max_evals=2e4)
    sched = BatchScheduler(_cfg(capacity=1 << 11, max_iters=200), FAMILY, devices=CPU)
    results = {r.req_id: r for r in sched.serve(list(reqs))}
    assert results[0].status == "deadline"
    assert results[0].n_evals > 2e4
    exact = FAMILY.exact(2, reqs[0].theta)
    assert abs(results[0].integral - exact) <= 1e-3 * abs(exact)
    assert all(r.status == "converged" for i, r in results.items() if i != 0)
    assert sched.last_stats["deadlines"] == 1


def test_wall_clock_deadline_evicts():
    reqs = _requests(2)
    # deadline_s=0: expired at the first dispatch boundary, guaranteed
    reqs[0] = dataclasses.replace(reqs[0], rel_tol=1e-9, deadline_s=0.0)
    results = {r.req_id: r for r in BatchScheduler(_cfg(), FAMILY, devices=CPU)
               .serve(list(reqs))}
    assert results[0].status == "deadline"
    assert results[1].status == "converged"


# --- service checkpoints and resume -------------------------------------------


@pytest.fixture(scope="module")
def fleet():
    """The crash fleet (request 0 tight, so it is in flight at the crash), the
    port's fault-free results, and the JAX service's."""
    reqs = _requests(8)
    reqs[0] = dataclasses.replace(reqs[0], rel_tol=1e-8)
    port = {r.req_id: r for r in BatchScheduler(_cfg(), FAMILY, devices=CPU).serve(list(reqs))}
    return reqs, port, _jax(reqs)


def test_fault_free_fleet_matches_the_jax_service(fleet):
    reqs, port, ref = fleet
    _check_reference(port, ref)


@pytest.mark.parametrize("every", [1, 2])
def test_crash_resume_union_is_bit_identical(tmp_path, fleet, every):
    reqs, port, ref = fleet
    ckpt = ServiceCheckpointer(str(tmp_path))
    pre, post = _crash_then_resume(_cfg(), reqs, ckpt, 3, checkpoint_every=every)
    got = _union(pre, post)
    assert got == _full(port.values())
    resumed = {r.req_id: r for r in pre + post}
    _check_reference(resumed, ref)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_snapshot_of_four_ranks_resumes_on_any_count(tmp_path, ranks):
    """Elastic restore: written by four ranks, resumed on ``ranks``."""
    cfg = _cfg(batch_slots=8)
    reqs = _requests(12)
    reqs[0] = dataclasses.replace(reqs[0], rel_tol=1e-8)
    want = _full(BatchScheduler(cfg, FAMILY, devices=CPU * 4).serve(list(reqs)))
    ckpt = ServiceCheckpointer(str(tmp_path))
    pre, post = _crash_then_resume(cfg, reqs, ckpt, 3, resume_devices=CPU * ranks,
                                   devices=CPU * 4, checkpoint_every=2)
    assert _union(pre, post) == want


def test_graceful_and_api_resume(tmp_path, fleet):
    from repro_torch.service import serve

    reqs, port, _ = fleet
    ckpt = ServiceCheckpointer(str(tmp_path))
    pre = []
    with pytest.raises(SimulatedCrash):
        for r in GracefulScheduler(_cfg(), FAMILY, devices=CPU, checkpointer=ckpt,
                                   checkpoint_every=1, on_tick=crash_at(3)).serve(list(reqs)):
            pre.append(r)
    post = list(serve(_cfg(), list(reqs), FAMILY, devices=CPU, graceful=True, resume=True,
                      checkpointer=ckpt))
    assert _union(pre, post) == _full(port.values())


def test_scheduler_checkpoint_arg_validation(tmp_path):
    with pytest.raises(ValueError, match="requires a checkpointer"):
        BatchScheduler(_cfg(), FAMILY, devices=CPU, checkpoint_every=2)
    with pytest.raises(ValueError, match=">= 0"):
        BatchScheduler(_cfg(), FAMILY, devices=CPU, checkpoint_every=-1)
    with pytest.raises(ValueError, match="max_dispatch_retries"):
        BatchScheduler(_cfg(), FAMILY, devices=CPU, max_dispatch_retries=-1)
    with pytest.raises(ValueError, match="dispatch_timeout_s"):
        BatchScheduler(_cfg(), FAMILY, devices=CPU, dispatch_timeout_s=0.0)
    sched = BatchScheduler(_cfg(), FAMILY, devices=CPU)
    with pytest.raises(ValueError, match="requires a checkpointer"):
        next(iter(sched.serve(_requests(1), resume=True)))
    sched = BatchScheduler(_cfg(), FAMILY, devices=CPU,
                           checkpointer=ServiceCheckpointer(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        next(iter(sched.serve(_requests(1), resume=True)))


# --- the fleet on the host -----------------------------------------------------


def _live_fleet(eng, n_run=2):
    state = eng.init()
    for s, req in enumerate(_requests(eng.n_slots, seed=3)):
        state = eng.admit(state, s, req.theta, rel_tol=1e-7 if s % 2 else None)
    for _ in range(n_run):
        state = eng.run(state, 1, 0)[0]
    return state


def _assert_host_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_cubature_to_host_place_round_trip(ranks):
    cfg = _cfg(batch_slots=8)
    eng = BatchEngine(cfg, devices=CPU * ranks)
    host = eng.to_host(_live_fleet(eng))
    assert {k: v.shape for k, v in host.items()} == eng.host_shapes()
    for other in (1, 2, 4):
        placed = BatchEngine(cfg, devices=CPU * other).place(host)
        _assert_host_equal(BatchEngine(cfg, devices=CPU * other).to_host(placed), host)


def test_vegas_to_host_place_round_trip():
    """The VEGAS pool has one rank: its snapshot places on a new pool and
    runs on with the same bits (admit_seq keys the draws)."""
    cfg = _cfg(backend="vegas", mc_samples=256, mc_max_iters=30)
    eng = VegasBatchEngine(cfg, devices=CPU)
    state = _live_fleet(eng)
    host = eng.to_host(state)
    assert {k: v.shape for k, v in host.items()} == eng.host_shapes()
    twin = VegasBatchEngine(cfg, devices=CPU)
    placed = twin.place(host)
    _assert_host_equal(twin.to_host(placed), host)
    a = eng.run(state, 4, 2)[1]
    b = twin.run(placed, 4, 2)[1]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("backend", ["cubature", "vegas"])
def test_snapshot_does_not_change_after_a_run(backend):
    """The engines update their state in place, and on a CPU rank
    ``t.cpu()`` is ``t``: the snapshot must be a copy."""
    cfg = _cfg(backend=backend, mc_samples=256)
    eng = (BatchEngine if backend == "cubature" else VegasBatchEngine)(cfg, devices=CPU)
    state = _live_fleet(eng)
    host = eng.to_host(state)
    frozen = {k: v.copy() for k, v in host.items()}
    state = eng.run(state, 4, 2)[0]
    assert not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(eng.to_host(state).values(), frozen.values()))
    _assert_host_equal(host, frozen)
    # and placing does not alias the host arrays either
    placed = eng.place(host)
    eng.run(placed, 4, 2)
    _assert_host_equal(host, frozen)


# --- the watchdog and rank loss ------------------------------------------------


def test_transient_device_fault_retry_is_bit_identical(fleet):
    reqs, port, _ = fleet
    sched = BatchScheduler(
        _cfg(), FAMILY, devices=CPU,
        fault_injector=DeviceDown(device=0, at_tick=1, transient_failures=2),
        max_dispatch_retries=3, retry_backoff_s=0.0,
    )
    assert _full(sched.serve(list(reqs))) == _full(port.values())
    assert sched.last_stats["dispatch_retries"] == 2
    assert sched.last_stats["evacuations"] == 0
    assert sched.last_stats["mesh_shrinks"] == 0


def test_permanent_loss_on_single_device_is_fatal():
    sched = BatchScheduler(
        _cfg(), FAMILY, devices=CPU, fault_injector=DeviceDown(device=0, at_tick=1),
        max_dispatch_retries=1, retry_backoff_s=0.0,
    )
    with pytest.raises(DeviceLostError):
        list(sched.serve(_requests(2)))
    assert sched.last_stats["dispatch_retries"] == 1


def test_hung_dispatch_converted_to_timeout_and_retried(fleet):
    reqs, port, _ = fleet
    sched = BatchScheduler(
        _cfg(), FAMILY, devices=CPU,
        fault_injector=DeviceDown(device=0, at_tick=1, transient_failures=1, mode="hang",
                                  hang_s=4.0),
        max_dispatch_retries=2, dispatch_timeout_s=TIMEOUT_S, retry_backoff_s=0.0,
    )
    assert _full(sched.serve(list(reqs))) == _full(port.values())
    assert sched.last_stats["dispatch_retries"] == 1


def test_hung_dispatch_permanent_raises_device_lost():
    sched = BatchScheduler(
        _cfg(), FAMILY, devices=CPU,
        fault_injector=DeviceDown(device=0, at_tick=1, mode="hang", hang_s=4.0),
        max_dispatch_retries=0, dispatch_timeout_s=TIMEOUT_S, retry_backoff_s=0.0,
    )
    # the hang is blamed on rank 0 through the injector's healthy() probe;
    # one rank has nowhere to evacuate to
    with pytest.raises(DeviceLostError):
        list(sched.serve(_requests(2)))


class _Waking(DeviceDown):
    """A hang whose abandoned thread signals when it wakes."""

    def __post_init__(self):
        super().__post_init__()
        self.woke = threading.Event()

    def pre_dispatch(self, it, device_indices):
        hung = self.device in device_indices and self._down(it)
        super().pre_dispatch(it, device_indices)
        if hung:
            self.woke.set()


def test_abandoned_dispatch_thread_wakes_mid_run_without_touching_the_state(fleet):
    """The hung attempt's thread wakes while the retried fleet still serves
    (the hook holds the loop at its next tick, slots in flight, until the
    thread has woken and had time to run a dispatch): it must leave the live
    state alone, since the engine updates it in place."""
    reqs, port, _ = fleet
    injector = _Waking(device=0, at_tick=1, transient_failures=1, mode="hang", hang_s=4.0)
    in_flight = []

    def hold(it, state, slot_req):
        if injector._fired and not in_flight:
            in_flight.append(sum(r is not None for r in slot_req))
            assert injector.woke.wait(30.0)
            time.sleep(0.5)

    sched = BatchScheduler(
        _cfg(), FAMILY, devices=CPU, fault_injector=injector, max_dispatch_retries=1,
        dispatch_timeout_s=TIMEOUT_S, retry_backoff_s=0.0, on_tick=hold,
    )
    results = list(sched.serve(list(reqs)))
    assert in_flight[0] > 0
    assert _full(results) == _full(port.values())
    assert sched.last_stats["dispatch_retries"] == 1


def test_watchdog_revokes_an_unclaimed_attempt_and_refuses_a_claimed_one():
    from repro_torch.service.scheduler import DispatchTimeout, _call_with_timeout

    claimed = []
    woke = threading.Event()

    def late(attempt):  # hangs before it touches the state
        time.sleep(0.3)
        claimed.append(attempt.claim())
        woke.set()

    with pytest.raises(DispatchTimeout):
        _call_with_timeout(late, 0.05)
    assert woke.wait(10.0) and claimed == [False]

    def busy(attempt):  # hangs while it changes the state
        assert attempt.claim()
        time.sleep(2 * TIMEOUT_S)

    with pytest.raises(RuntimeError, match="neither abandoned nor retried"):
        _call_with_timeout(busy, TIMEOUT_S)
    assert _call_with_timeout(lambda attempt: attempt.claim(), 5.0) is True
    assert _call_with_timeout(lambda attempt: attempt.claim(), None) is True


def test_claim_and_revoke_race_has_one_winner():
    """Stress: many threads race a claim against a revoke, with a short
    switch interval; each attempt has exactly one winner."""
    from repro_torch.service.scheduler import _Attempt

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        attempts = [_Attempt() for _ in range(2000)]
        wins = {"claim": [0] * len(attempts), "revoke": [0] * len(attempts)}

        def race(kind):
            for i, a in enumerate(attempts):
                wins[kind][i] += getattr(a, kind)()

        threads = [threading.Thread(target=race, args=(kind,))
                   for kind in ("claim", "revoke") * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    # every claimer after a claim also wins (the same state, claimed), but a
    # revoke after a claim never does, nor a claim after a revoke
    for c, r in zip(wins["claim"], wins["revoke"]):
        assert (c == 0) != (r == 0), (c, r)


def test_rank_loss_shrinks_and_regrows_with_the_fault_free_values():
    cfg = _cfg(batch_slots=8)
    reqs = _requests(12, rel_tol=1e-5)
    want = _vals(BatchScheduler(cfg, FAMILY, devices=CPU * 4).serve(list(reqs)))
    sched = BatchScheduler(
        cfg, FAMILY, devices=CPU * 4,
        fault_injector=DeviceDown(device=2, at_tick=2, restore_at_tick=5),
        max_dispatch_retries=1, retry_backoff_s=0.0,
    )
    results = list(sched.serve(list(reqs)))
    assert _vals(results) == want
    st = sched.last_stats
    assert st["evacuations"] > 0 and st["mesh_shrinks"] == 1 and st["mesh_regrows"] == 1, st
    assert sched.engine.n_ranks == 4
    for r in results:
        assert r.evacuated in (None, "readmit")
        assert (r.attempts, r.retried_from) == ((2, "device_lost") if r.evacuated else (1, None))


def test_device_down_injector_validation():
    with pytest.raises(ValueError, match="mode"):
        DeviceDown(device=0, at_tick=1, mode="explode")


# --- corrupted-snapshot fallback ------------------------------------------------


def _meta(**kw):
    return dict({"it": 1, "ticks": 1, "stats": {}, "pulled_ids": [], "slots": []}, **kw)


def test_restore_falls_back_past_corrupt_meta(tmp_path):
    """A truncated meta sidecar must not brick resume: the previous snapshot
    restores."""
    eng = BatchEngine(_cfg(), devices=CPU)
    host = eng.to_host(eng.init())
    ckpt = ServiceCheckpointer(str(tmp_path))
    ckpt.save(1, host, _meta(it=4))
    ckpt.save(2, host, _meta(it=8))
    p = tmp_path / "meta_00000002.json"
    raw = p.read_bytes()
    p.write_bytes(raw[: len(raw) // 2])
    _, got = ckpt.restore(eng)
    assert got["it"] == 4  # fell back to step 1
    with pytest.raises(json.JSONDecodeError):
        ckpt.restore(eng, step=2)  # explicit step: no silent fallback


def test_restore_rejects_meta_missing_required_keys(tmp_path):
    eng = BatchEngine(_cfg(), devices=CPU)
    host = eng.to_host(eng.init())
    ckpt = ServiceCheckpointer(str(tmp_path))
    ckpt.save(1, host, _meta(it=2))
    ckpt.save(2, host, {"it": 9})  # valid JSON, but a partial sidecar
    assert json.loads((tmp_path / "meta_00000002.json").read_text())["it"] == 9
    _, got = ckpt.restore(eng)
    assert got["it"] == 2
    with pytest.raises(KeyError):
        ckpt.restore(eng, step=2)


def test_restore_falls_back_past_a_crc_failure(tmp_path):
    eng = BatchEngine(_cfg(), devices=CPU)
    host = eng.to_host(eng.init())
    ckpt = ServiceCheckpointer(str(tmp_path))
    ckpt.save(1, host, _meta(it=3))
    ckpt.save(2, host, _meta(it=6))
    mpath = tmp_path / "state" / "step_00000002" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["leaves"]["regions/centers"]["crc32"] ^= 1
    mpath.write_text(json.dumps(manifest))
    _, got = ckpt.restore(eng)
    assert got["it"] == 3
    _, meta, step = ckpt.restore_host(host)
    assert (meta["it"], step) == (3, 1)


def test_restore_raises_when_every_snapshot_corrupt(tmp_path):
    eng = BatchEngine(_cfg(), devices=CPU)
    ckpt = ServiceCheckpointer(str(tmp_path))
    ckpt.save(1, eng.to_host(eng.init()), _meta())
    p = tmp_path / "meta_00000001.json"
    p.write_bytes(p.read_bytes()[:10])
    with pytest.raises(FileNotFoundError, match="all corrupt"):
        ckpt.restore(eng)


def test_snapshot_gc_drops_old_sidecars(tmp_path):
    eng = BatchEngine(_cfg(), devices=CPU)
    host = eng.to_host(eng.init())
    ckpt = ServiceCheckpointer(str(tmp_path), keep=2)
    for s in range(1, 5):
        ckpt.save(s, host, _meta(it=s))
    assert ckpt.complete_steps() == [3, 4] and ckpt.latest_step() == 4
    assert sorted(p.name for p in tmp_path.glob("meta_*")) == [
        "meta_00000003.json", "meta_00000004.json"]


# --- CheckpointManager async errors ---------------------------------------------


def test_async_write_error_resurfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arrays = {"x": np.arange(4.0)}
    mgr.save(1, arrays, blocking=True)
    mgr.save(1, arrays)  # a re-save fails in the background thread
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()  # surfaced once, then the manager is usable again
    mgr.save(2, arrays)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_async_write_error_resurfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    arrays = {"x": np.arange(4.0)}
    mgr.save(1, arrays, blocking=True)
    mgr.save(1, arrays)
    with pytest.raises(FileExistsError):
        mgr.save(3, arrays)  # save() waits on the pending thread first
    mgr.save(3, arrays)
    mgr.wait()
    assert mgr.latest_step() == 3


# --- injector hygiene -------------------------------------------------------------


def test_poison_theta_only_touches_first_leaf():
    from repro.service.faults import poison_theta as jpoison_theta

    theta = FAMILY.sample_theta(2, np.random.default_rng(0))
    bad = poison_theta(theta)
    ref = jpoison_theta(theta)
    assert sorted(bad) == sorted(ref)
    for k in theta:
        np.testing.assert_array_equal(bad[k], np.asarray(ref[k]))
    assert np.all(bad["a"] == NAN_SENTINEL)
    np.testing.assert_array_equal(bad["u"], theta["u"])


# --- the CLI ---------------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_quad", "--device", "cpu", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


def _lines(stdout):
    return [line.split("] ", 1)[1] for line in stdout.splitlines() if line.startswith("[")]


def test_cli_checkpoint_and_resume_round_trip(tmp_path):
    """A run that snapshots every 5th tick, then a resume from its newest
    snapshot: the resumed results are the first run's, line for line."""
    args = ["--d", "2", "--n-requests", "12", "--batch-slots", "4", "--rel-tols", "1e-2,1e-7",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "5"]
    first = _cli(*args)
    assert first.returncode == 0, first.stderr[-2000:]
    assert len(_lines(first.stdout)) == 12
    resumed = _cli(*args, "--resume")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    again = _lines(resumed.stdout)
    assert again and set(again) <= set(_lines(first.stdout)), (again, first.stdout)


def test_cli_chaos_fail_device_evacuates_and_regrows():
    proc = _cli("--d", "2", "--n-requests", "16", "--batch-slots", "8", "--devices", "4",
                "--chaos-fail-device", "2:2:6", "--validate")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(_lines(proc.stdout)) == 16
    stats = proc.stdout.splitlines()[-1]
    assert "mesh_shrinks=1" in stats and "mesh_regrows=1" in stats, stats


@pytest.mark.parametrize(
    "args, message",
    [
        (["--resume"], "--resume requires --checkpoint-dir"),
        (["--chaos-fail-device", "0:2"], "--devices >= 2"),
        (["--devices", "2", "--batch-slots", "4", "--chaos-fail-device", "nonsense"], "DEV:TICK"),
        (["--devices", "2", "--batch-slots", "4", "--chaos-fail-device", "5:2"], "out of range"),
    ],
    ids=["resume", "one-rank", "format", "range"],
)
def test_cli_resilience_flag_validation(args, message):
    proc = _cli(*args)
    assert proc.returncode != 0
    assert message in proc.stderr, proc.stderr[-500:]
