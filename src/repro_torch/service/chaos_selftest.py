"""The batch service through every fault injector, at 1, 2 and 4 ranks.

    PYTHONPATH=src python -m repro_torch.service.chaos_selftest [n_ranks] [cpu|cuda] [-q|-v]

The port of the JAX package's ``repro.service.chaos_selftest``: the same
fleet, scenarios and asserts, on ``["cpu"] * c`` or ``cuda_devices(c)``
ranks for c in (1, 2, 4) up to ``n_ranks`` (the ranks live in this one
process, so no subprocess per count).  It asserts the service's contract
under faults:

- **survival**: every scenario completes, and every request yields exactly
  one result;
- **containment**: in a fleet with NaN-poisoned or corrupted slots, every
  healthy request converges with ``(integral, error, status, iterations,
  n_evals)`` bit-identical to the fault-free run;
- **re-routing**: quarantined and corrupted requests carry provenance
  (``attempts=2``, ``retried_from``, backend ``vegas``);
- **resume parity**: after a mid-serve crash, ``resume=True`` replays to a
  result set whose union with the results before the crash is the
  fault-free run's, bit for bit (replayed duplicates included);
- **deadlines**: an expired SLO evicts with a finite partial estimate;
- **rank loss** (c >= 2): a rank lost mid-run is evacuated and the fleet
  completes on the smaller rank set, every request's values bit-identical
  to the fault-free run, the lost rank's requests with snapshot or
  re-admission provenance, the smaller ring keeping the
  ``make_schedule`` / ``ring_perms`` invariants; a transient fault retries
  to a fully bit-identical run; a healed rank regrows the rank set;
- **elastic restore**: a snapshot written on the most ranks restores onto
  every smaller count with every slot's bits.

Progress goes through ``logging``; the ``RESULT_JSON:`` line is printed
last.
"""

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

from repro_torch.telemetry.logutil import add_verbosity_flags, setup_logging


def full(results):
    """Full result tuples, scheduling included (parity across rank counts)."""
    return [
        (
            r.req_id,
            float(r.integral).hex(),
            float(r.error).hex(),
            r.status,
            r.iterations,
            r.n_evals,
            r.admitted_at,
            r.finished_at,
        )
        for r in sorted(results, key=lambda r: r.req_id)
    ]


def values(results):
    """Value tuples, scheduling excluded.  A slot's trajectory depends only on
    its theta, its tolerances and the config, not on when it was admitted or
    on the other slots, so these compare healthy requests between a faulty
    fleet (whose extra or failed requests shift admissions) and the
    fault-free one."""
    return {
        r.req_id: (
            float(r.integral).hex(),
            float(r.error).hex(),
            r.status,
            r.iterations,
            r.n_evals,
        )
        for r in results
    }


def fleet():
    """``(cfg, family, base_reqs)``: the JAX self-test's fleet.  Request 0 runs
    at a tight tolerance, so it is still in flight when the corruption and
    deadline injectors fire."""
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import get_param
    from repro_torch.service.scheduler import QuadRequest

    family = get_param("genz_gaussian")
    d = 2
    cfg = QuadratureConfig(
        d=d, integrand="genz_gaussian", rel_tol=1e-3, capacity=1 << 10,
        batch_slots=8, max_iters=80, sync_every=4,
    )
    rng = np.random.default_rng(0)
    rel_tols = [1e-6] + [1e-3] * 9
    reqs = [
        QuadRequest(req_id=i, theta=family.sample_theta(d, rng), rel_tol=rel_tols[i])
        for i in range(10)
    ]
    return cfg, family, reqs


def _crash(sched, reqs):
    """Serve until the scheduler's crash hook fires; the results before it."""
    from repro_torch.service.faults import SimulatedCrash

    pre = []
    try:
        for r in sched.serve(list(reqs)):
            pre.append(r)
    except SimulatedCrash:
        return pre
    raise AssertionError("crash injector never fired")


def _union(pre, post, want, where):
    """Union of the results before a crash and after its resume, asserted
    equal to ``want`` (replays must be bit-identical duplicates)."""
    by_id = {}
    for r in pre + post:
        t = full([r])[0]
        assert by_id.setdefault(r.req_id, t) == t, (where, by_id[r.req_id], t)
    union = [by_id[k] for k in sorted(by_id)]
    assert union == want, (where, union[:2], want[:2])
    return len(pre) + len(post) - len(by_id)


def run(n_ranks: int = 4, kind: str = "cuda", log=None) -> dict:
    """Every scenario at 1, 2 and 4 ranks up to ``n_ranks`` on ``kind``
    ("cpu" or "cuda"); returns the summary (raises if an assert fails)."""
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.core.redistribution import check_ring_invariants
    from repro_torch.service import BatchScheduler, QuadRequest, ServiceCheckpointer
    from repro_torch.service.faults import (
        DeviceDown,
        corrupt_slot_hook,
        crash_at,
        nan_family,
        poison_theta,
        storm_requests,
    )
    from repro_torch.service.routing import GracefulScheduler

    if kind not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {kind!r}")
    log = log or setup_logging(quiet=True)

    def ranks(c):
        return ["cpu"] * c if kind == "cpu" else cuda_devices(c)

    counts = [c for c in (1, 2, 4) if c <= n_ranks]
    cfg, family, base_reqs = fleet()
    d = cfg.d
    healthy_ids = {r.req_id for r in base_reqs}

    out = {"n_devices": n_ranks, "device": kind, "device_counts": counts, "scenarios": {}}
    baseline_by_count = {}
    for c in counts:
        devices = ranks(c)
        scen = {}
        log.info("ranks=%d ...", c)

        # --- fault-free reference -------------------------------------------
        baseline = list(BatchScheduler(cfg, family, devices=devices).serve(list(base_reqs)))
        assert all(r.status == "converged" for r in baseline), full(baseline)
        baseline_by_count[c] = full(baseline)
        base_vals = values(baseline)
        scen["baseline"] = {"n_results": len(baseline)}

        # --- NaN-poisoned integrands ----------------------------------------
        # Three poisoned requests ride along with the ten healthy ones; the
        # wrapped family gives NaN for sentinel thetas only (on the card,
        # through the GM evaluate's sentinel route).  Cubature quarantines
        # them, the graceful layer retries them on VEGAS (NaN too: the
        # integrand really is broken), and the results carry the provenance.
        wrapped = nan_family(family)
        poisoned = [
            QuadRequest(req_id=100 + i, theta=poison_theta(base_reqs[0].theta)) for i in range(3)
        ]
        mixed = base_reqs[:5] + poisoned + base_reqs[5:]
        graceful = GracefulScheduler(cfg, wrapped, devices=devices)
        results = list(graceful.serve(list(mixed)))
        assert len(results) == len(mixed), full(results)
        vals = values(results)
        for rid in healthy_ids:
            assert vals[rid] == base_vals[rid], (rid, vals[rid], base_vals[rid])
            assert vals[rid][2] == "converged", vals[rid]
        for p in poisoned:
            r = next(r for r in results if r.req_id == p.req_id)
            assert r.status == "nonfinite", r
            assert r.attempts == 2 and r.retried_from == "nonfinite", r
            assert r.backend == "vegas", r
        st = graceful.last_stats
        assert st["quarantines"] >= 2 * len(poisoned), st
        assert st["reroutes"] == len(poisoned), st
        scen["nan_injection"] = {
            "quarantines": st["quarantines"],
            "reroutes": st["reroutes"],
            "healthy_parity": True,
        }

        # --- forced slot corruption -----------------------------------------
        # Slot 0 (the tight-tolerance request 0) gets NaN centres mid-serve:
        # the engine quarantines it the next iteration, and the graceful
        # layer re-routes it to VEGAS, where the healthy integrand gives a
        # real estimate again.
        graceful = GracefulScheduler(
            cfg, family, devices=devices, on_tick=corrupt_slot_hook(0, 1, req_id=0)
        )
        results = list(graceful.serve(list(base_reqs)))
        assert len(results) == len(base_reqs), full(results)
        vals = values(results)
        corrupted = next(r for r in results if r.req_id == 0)
        assert corrupted.attempts == 2, corrupted
        assert corrupted.retried_from == "nonfinite", corrupted
        assert corrupted.backend == "vegas", corrupted
        assert corrupted.status in ("converged", "max_iters"), corrupted
        assert np.isfinite(corrupted.integral), corrupted
        exact = family.exact(d, base_reqs[0].theta)
        assert abs(corrupted.integral - exact) <= 1e-2 * abs(exact), (corrupted.integral, exact)
        for rid in healthy_ids - {0}:
            assert vals[rid] == base_vals[rid], (rid, vals[rid], base_vals[rid])
        scen["slot_corruption"] = {"rerouted_status": corrupted.status, "healthy_parity": True}

        # --- mid-serve crash and resume ---------------------------------------
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = ServiceCheckpointer(tmp)
            # snapshot every other admission tick and crash off-cycle, so
            # some results land between the last snapshot and the crash: the
            # resumed run must serve them again with the same bits
            crashing = BatchScheduler(
                cfg, family, devices=devices, checkpointer=ckpt, checkpoint_every=2,
                on_tick=crash_at(3),
            )
            pre = _crash(crashing, base_reqs)
            assert ckpt.latest_step() is not None, os.listdir(tmp)
            resumed = BatchScheduler(cfg, family, devices=devices, checkpointer=ckpt)
            post = list(resumed.serve(list(base_reqs), resume=True))
            replayed = _union(pre, post, baseline_by_count[c], f"crash_resume ranks={c}")
            assert replayed > 0, (len(pre), len(post))
            scen["crash_resume"] = {
                "pre_crash": len(pre),
                "post_resume": len(post),
                "replayed": replayed,
                "union_parity": True,
            }

        # --- queue storm ----------------------------------------------------
        storm_n = 40
        sched = BatchScheduler(cfg, family, devices=devices)
        results = list(sched.serve(storm_requests(family, d, storm_n, seed=11)))
        assert len(results) == storm_n, len(results)
        assert all(r.status == "converged" for r in results), full(results)[:3]
        midflight = sum(1 for r in results if r.admitted_at > 0)
        assert midflight > 0, full(results)
        scen["queue_storm"] = {"n_results": len(results), "midflight_admissions": midflight}

        # --- deadline SLO ---------------------------------------------------
        # Request 0 gets a hopeless tolerance and a small evaluation budget:
        # it is evicted with a finite partial estimate, while every other
        # trajectory stays bit-identical to the fault-free run.
        slo_reqs = [dataclasses.replace(base_reqs[0], rel_tol=1e-12, max_evals=3e4)] + base_reqs[1:]
        sched = BatchScheduler(cfg, family, devices=devices)
        results = list(sched.serve(slo_reqs))
        assert len(results) == len(slo_reqs), full(results)
        vals = values(results)
        dl = next(r for r in results if r.req_id == 0)
        assert dl.status == "deadline", dl
        assert dl.n_evals > 3e4, dl
        assert np.isfinite(dl.integral) and np.isfinite(dl.error), dl
        assert sched.last_stats["deadlines"] == 1, sched.last_stats
        for rid in healthy_ids - {0}:
            assert vals[rid] == base_vals[rid], (rid, vals[rid], base_vals[rid])
        scen["deadline"] = {"partial_evals": dl.n_evals, "healthy_parity": True}

        # --- rank loss (elastic rank set) -------------------------------------
        # Only with several ranks: one rank has nowhere to evacuate to.
        if c >= 2:
            # lost for good, no snapshot: the lost rank's requests are
            # admitted again from scratch with provenance, and every request
            # lands with the fault-free values (trajectories do not depend
            # on placement)
            sched = BatchScheduler(
                cfg, family, devices=devices, fault_injector=DeviceDown(device=1, at_tick=2),
                max_dispatch_retries=1, retry_backoff_s=0.0,
            )
            results = list(sched.serve(list(base_reqs)))
            assert len(results) == len(base_reqs), full(results)
            vals = values(results)
            for rid in healthy_ids:
                assert vals[rid] == base_vals[rid], (rid, vals[rid], base_vals[rid])
            affected = [r for r in results if r.evacuated]
            assert affected, full(results)
            for r in affected:
                assert r.evacuated == "readmit", r
                assert r.attempts == 2 and r.retried_from == "device_lost", r
            st = sched.last_stats
            assert st["dispatch_retries"] == 1, st
            assert st["mesh_shrinks"] == 1, st
            assert st["evacuations"] == len(affected), (st, len(affected))
            assert sched.engine.n_ranks < c, sched.engine.n_ranks
            check_ring_invariants(sched.engine.n_ranks)
            scen["device_kill_readmit"] = {
                "evacuated": len(affected),
                "shrunk_to": sched.engine.n_ranks,
                "healthy_parity": True,
            }

            # lost for good with snapshots: slots in the newest snapshot
            # rewind and replay (no extra attempt); the others are admitted
            # again
            with tempfile.TemporaryDirectory() as tmp:
                sched = BatchScheduler(
                    cfg, family, devices=devices, checkpointer=ServiceCheckpointer(tmp),
                    checkpoint_every=1, fault_injector=DeviceDown(device=1, at_tick=3),
                    max_dispatch_retries=1, retry_backoff_s=0.0,
                )
                results = list(sched.serve(list(base_reqs)))
            assert len(results) == len(base_reqs), full(results)
            vals = values(results)
            for rid in healthy_ids:
                assert vals[rid] == base_vals[rid], (rid, vals[rid], base_vals[rid])
            affected = [r for r in results if r.evacuated]
            assert any(r.evacuated == "snapshot" for r in affected), full(results)
            for r in affected:
                assert r.evacuated in ("snapshot", "readmit"), r
                if r.evacuated == "snapshot":
                    assert r.attempts == 1 and r.retried_from is None, r
                else:
                    assert r.attempts == 2 and r.retried_from == "device_lost", r
            st = sched.last_stats
            assert st["mesh_shrinks"] == 1, st
            assert st["evacuations"] == len(affected), (st, len(affected))
            scen["device_kill_snapshot"] = {
                "evacuated": len(affected),
                "snapshot_recovered": sum(1 for r in affected if r.evacuated == "snapshot"),
                "healthy_parity": True,
            }

            # transient fault: the retry budget covers it, so the run is
            # fully bit-identical (scheduling included)
            sched = BatchScheduler(
                cfg, family, devices=devices,
                fault_injector=DeviceDown(device=1, at_tick=2, transient_failures=2),
                max_dispatch_retries=3, retry_backoff_s=0.0,
            )
            results = list(sched.serve(list(base_reqs)))
            assert full(results) == baseline_by_count[c], full(results)[:2]
            st = sched.last_stats
            assert st["dispatch_retries"] == 2, st
            assert st["mesh_shrinks"] == 0 and st["evacuations"] == 0, st
            assert sched.engine.n_ranks == c, sched.engine.n_ranks
            scen["device_transient"] = {"retries": 2, "full_parity": True}

            # loss, then heal: the rank set shrinks, serves, and regrows to
            # the original count at a later admission tick
            storm_n2 = 24
            ref = list(BatchScheduler(cfg, family, devices=devices).serve(
                storm_requests(family, d, storm_n2, seed=7)))
            sched = BatchScheduler(
                cfg, family, devices=devices,
                fault_injector=DeviceDown(device=1, at_tick=2, restore_at_tick=6),
                max_dispatch_retries=1, retry_backoff_s=0.0,
            )
            results = list(sched.serve(storm_requests(family, d, storm_n2, seed=7)))
            assert len(results) == storm_n2, len(results)
            assert values(results) == values(ref), full(results)[:2]
            st = sched.last_stats
            assert st["mesh_shrinks"] == 1, st
            assert st["mesh_regrows"] >= 1, st
            assert sched.engine.n_ranks == c, sched.engine.n_ranks
            check_ring_invariants(sched.engine.n_ranks)
            scen["device_regrow"] = {
                "regrows": st["mesh_regrows"],
                "final_devices": sched.engine.n_ranks,
                "healthy_parity": True,
            }

        log.debug("  ranks=%d: %s", c, json.dumps(scen))
        out["scenarios"][f"devices_{c}"] = scen

    # the fault-free runs themselves agree across rank counts, scheduling
    # included
    ref = baseline_by_count[counts[0]]
    for c in counts[1:]:
        assert baseline_by_count[c] == ref, (c, baseline_by_count[c][:2], ref[:2])

    # --- elastic restore across rank counts ----------------------------------
    # One crash on the most ranks, then the same snapshots resumed on every
    # smaller count: each resumed fleet must replay to the same results.
    c_hi = counts[-1]
    if c_hi > 1:
        restored_to = {}
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = ServiceCheckpointer(tmp)
            pre = _crash(BatchScheduler(
                cfg, family, devices=ranks(c_hi), checkpointer=ckpt, checkpoint_every=2,
                on_tick=crash_at(3),
            ), base_reqs)
            for c_lo in [c for c in counts if c < c_hi]:
                # restore only (checkpoint_every=0): the snapshots stay as
                # they are, so every count resumes from the same point
                resumed = BatchScheduler(cfg, family, devices=ranks(c_lo), checkpointer=ckpt)
                post = list(resumed.serve(list(base_reqs), resume=True))
                _union(pre, post, baseline_by_count[c_hi], f"elastic_restore {c_hi}->{c_lo}")
                restored_to[str(c_lo)] = len(post)
        out["elastic_restore"] = {
            "from_devices": c_hi,
            "restored_to": restored_to,
            "union_parity": True,
        }
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_ranks", nargs="?", type=int, default=4)
    ap.add_argument("device", nargs="?", default="cuda", choices=("cpu", "cuda"))
    add_verbosity_flags(ap)
    args = ap.parse_args(argv)
    log = setup_logging(quiet=args.quiet, verbose=args.verbose)
    print("RESULT_JSON:" + json.dumps(run(args.n_ranks, args.device, log)))


if __name__ == "__main__":
    main()
