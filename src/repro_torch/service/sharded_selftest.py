"""Multi-rank self-test of the port's batch service, one JSON blob on the
last line.

    PYTHONPATH=src python -m repro_torch.service.sharded_selftest [n_ranks] [cpu|cuda]

Runs the JAX package's sharded-service cases (``repro.service.sharded_selftest``:
``converged_midflight``, ``evicted``, ``max_iters`` and ``rebalanced``)
through :class:`~repro_torch.service.scheduler.BatchScheduler` at 1, 2, 4
and 8 ranks up to ``n_ranks``, with the rebalancer off and with the
advance unwindowed on the most ranks, and asserts that every
:class:`QuadResult` (integral, error, status, iterations, n_evals,
admitted_at, finished_at) is the same in every run, and that the
drain-heavy case migrates.  The drain-heavy case is replayed once more on
the most ranks with a telemetry recorder attached: the same results bit for
bit, one ``service.migrate`` flow per migration, a Chrome trace that passes
:func:`repro_torch.telemetry.check.check_trace`, and the per-rank idle
fraction equal to its formula recomputed from the raw gauge events.  The
ranks run on the CPU (``cpu``) or on the visible GPUs (``cuda``, the
default: rank r on cuda:(r mod count)).  Prints ``RESULT_JSON:`` and the
summary.
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np


def tuples(results):
    """The comparable fields of each result, by req_id (floats as hex)."""
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


def cases(family, d=2):
    """The JAX self-test's cases: name -> (config fields, request maker)."""

    def requests(n, seed, rel_tols=None):
        from repro_torch.service.scheduler import QuadRequest

        rng = np.random.default_rng(seed)
        return [
            QuadRequest(
                req_id=i,
                theta=family.sample_theta(d, rng),
                rel_tol=None if rel_tols is None else rel_tols[i],
            )
            for i in range(n)
        ]

    base = dict(d=d, integrand=family.name, sync_every=4)
    return {
        # more requests than slots: mid-flight admission at every rank count
        "converged_midflight": (
            dict(base, rel_tol=1e-5, capacity=1 << 9, batch_slots=8, max_iters=80),
            lambda: requests(14, seed=0),
        ),
        # undersized store + hopeless tolerance: the hard slot overflows,
        # grinds through evict_patience and is evicted ("capacity")
        "evicted": (
            dict(base, rel_tol=1e-4, capacity=1 << 7, batch_slots=8, max_iters=80),
            lambda: requests(12, seed=3, rel_tols=[1e-9] + [1e-4] * 11),
        ),
        # iteration cap: frozen after exactly max_iters evaluate steps
        "max_iters": (
            dict(base, rel_tol=1e-14, capacity=1 << 9, batch_slots=8, max_iters=6),
            lambda: requests(8, seed=7),
        ),
        # drain-heavy fleet: parity-striped tolerances drain half the ranks,
        # which then pull queued problems from their ring partners
        "rebalanced": (
            dict(base, rel_tol=1e-8, capacity=1 << 10, batch_slots=16, max_iters=150),
            lambda: requests(
                16, seed=1, rel_tols=[1e-2 if i % 2 == 0 else 1e-8 for i in range(16)]
            ),
        ),
    }


def telemetry_replay(cfg, family, make_reqs, devices, want) -> dict:
    """The recorder-on replay of one case on ``devices``: raises unless its
    results are ``want`` bit for bit, it records one ``service.migrate``
    flow per migration (at least one when there are several ranks), its
    Chrome trace passes the checker, and the idle fraction of every rank
    equals 1 - occupied slot-iterations / capacity recomputed by hand from
    the ``service.n_live`` gauges."""
    from repro_torch.service.scheduler import BatchScheduler
    from repro_torch.telemetry import MemorySink, Recorder, loadview
    from repro_torch.telemetry.check import check_trace
    from repro_torch.telemetry.trace import write_chrome_trace

    c = len(devices)
    sink = MemorySink()
    rec = Recorder(sinks=(sink,))
    sched = BatchScheduler(cfg, family, devices=devices, recorder=rec)
    got = tuples(sched.serve(make_reqs()))
    rec.close()
    assert got == want, (
        "recorder-on run diverged from recorder-off run",
        [a for a, b in zip(got, want) if a != b][:2],
    )
    flows = [e for e in sink.events if e["kind"] == "flow_begin" and e["name"] == "service.migrate"]
    assert len(flows) == sched.last_stats["migrations"], (len(flows), sched.last_stats)
    assert c == 1 or flows, sched.last_stats
    per_rank = cfg.batch_slots // c
    tl = loadview.occupancy_from_events(sink.events)
    assert tl.devices == list(range(c)), tl.devices
    idle = loadview.idle_fraction(tl, per_rank)
    occ, its = {}, set()
    for e in sink.events:
        if e["kind"] == "gauge" and e["name"] == "service.n_live":
            occ[e["lane"]] = occ.get(e["lane"], 0.0) + e["value"]
            its.add(e["it"])
    for r in range(c):
        hand = 1.0 - occ.get(r, 0.0) / (len(its) * per_rank)
        assert abs(idle[r] - hand) < 1e-12, (r, idle[r], hand)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        write_chrome_trace(path, sink.events)
        problems = check_trace(path, n_devices=c, expect_flow=c > 1)
        assert not problems, problems
    return {
        "devices": c,
        "parity": True,
        "migration_flows": len(flows),
        "idle_fraction": [idle[r] for r in range(c)],
        "trace_check": "ok",
    }


def run(n_ranks: int = 4, kind: str = "cuda") -> dict:
    """Run every case at 1, 2, 4 and 8 ranks up to ``n_ranks``; returns the
    summary, with each case's result tuples (raises if any run differs)."""
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {kind!r}")

    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import get_param
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.service.scheduler import BatchScheduler

    def devices(n):
        return ["cpu"] * n if kind == "cpu" else cuda_devices(n)

    counts = [c for c in (1, 2, 4, 8) if c <= n_ranks]
    family = get_param("genz_gaussian")
    out = {"n_devices": n_ranks, "device": kind, "device_counts": counts, "cases": {}}
    for name, (fields, make_reqs) in cases(family).items():
        cfg = QuadratureConfig(**fields)
        per_count, migrations = {}, {}
        for c in counts:
            sched = BatchScheduler(cfg, family, devices=devices(c))
            per_count[c] = tuples(sched.serve(make_reqs()))
            migrations[c] = sched.last_stats["migrations"]
        # rebalancing is a pure placement change, and the windowed advance a
        # pure cost change: the same results without them, on the most ranks
        for key, change in (("off", {"rebalance": "off"}), ("adv_off", {"advance_window": False})):
            sched = BatchScheduler(
                dataclasses.replace(cfg, **change), family, devices=devices(counts[-1])
            )
            per_count[key] = tuples(sched.serve(make_reqs()))
        ref = per_count[1]
        for key, got in per_count.items():
            assert got == ref, (name, key, [a for a, b in zip(got, ref) if a != b][:2])
        out["cases"][name] = {
            "statuses": sorted({t[3] for t in ref}),
            "midflight_admissions": sum(1 for t in ref if t[6] > 0),
            "migrations": migrations,
            "parity": True,
            "n_results": len(ref),
            "admitted_at": sorted({t[6] for t in ref}),
            "results": ref,
        }

        if name == "rebalanced":
            out["cases"][name]["telemetry"] = telemetry_replay(
                cfg, family, make_reqs, devices(counts[-1]), per_count[counts[-1]]
            )

    for c in counts[1:]:
        assert out["cases"]["rebalanced"]["migrations"][c] > 0, out
    assert "capacity" in out["cases"]["evicted"]["statuses"], out
    assert "max_iters" in out["cases"]["max_iters"]["statuses"], out
    assert out["cases"]["converged_midflight"]["midflight_admissions"] > 0, out
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    n_ranks = int(argv[0]) if argv else 4
    kind = argv[1] if len(argv) > 1 else "cuda"
    if kind not in ("cpu", "cuda"):
        raise SystemExit(f"device must be cpu or cuda, got {kind!r}")
    print("RESULT_JSON:" + json.dumps(run(n_ranks, kind)))


if __name__ == "__main__":
    main()
