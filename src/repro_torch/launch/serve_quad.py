"""Batch quadrature service launcher: continuous batching over a request fleet.

Serve 64 random Genz-Gaussian problems through 16 batch slots on the GPU:
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --family genz_gaussian \\
      --d 3 --n-requests 64 --batch-slots 16
The same on the CPU (the plain PyTorch path), four ranks with cyclic problem
rebalancing, easy and hard problems striped over the fleet:
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --d 3 \\
      --n-requests 32 --batch-slots 8 --devices 4 --rel-tols 1e-2,1e-7 --validate
A high-dimensional fleet through the VEGAS pool (one rank):
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --backend vegas \\
      --d 10 --n-requests 6 --batch-slots 2 --rel-tol 1e-3 --mc-iters 60 --validate
Graceful re-routing (capacity evictions go to a VEGAS pool):
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --graceful \\
      --d 2 --capacity 32 --rel-tol 1e-7 --n-requests 4 --batch-slots 2 --validate
Snapshots every 5th admission tick, and a resume from the newest one (it
serves again the requests in flight at that snapshot, with the same bits):
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --d 3 \\
      --n-requests 16 --batch-slots 4 --checkpoint-dir /tmp/quad-ckpt --checkpoint-every 5
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --d 3 \\
      --n-requests 16 --batch-slots 4 --checkpoint-dir /tmp/quad-ckpt --checkpoint-every 5 --resume
Rank 2 of 4 lost at iteration 3 and back at 9: its slots are evacuated, the
ranks shrink to 2, and regrow to 4; --strict exits 1 unless every result is
finite and converged, and logs each request that needed a recovery:
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --d 3 \\
      --n-requests 32 --batch-slots 8 --devices 4 --chaos-fail-device 2:3:9 --strict
Explicit problems (one family spec per --request) under the Gauss-Kronrod
rule, with a Chrome trace and the event stream:
  PYTHONPATH=src python -m repro_torch.launch.serve_quad --device cpu --d 2 \\
      --rule gauss_kronrod --request genz_gaussian:5,5:0.3,0.7 \\
      --request genz_gaussian:8,2:0.5,0.5 --trace /tmp/q.json --metrics /tmp/q.jsonl

Runs on the CUDA device unless ``--device cpu`` is given; ``--devices N``
runs N ranks from this one process (rank r on cuda:(r mod device count)).
Progress goes through ``logging`` to stdout (``--quiet`` / ``--verbose``).
The JAX CLI's ``--use-kernel`` and ``--interpret`` (its Pallas path) are
refused: the device picks the path here.
"""

import argparse
import math
import sys
import time

from repro_torch.telemetry.flags import (
    CliTelemetry,
    add_pallas_flags,
    add_telemetry_flags,
    refuse_pallas_flags,
)
from repro_torch.telemetry.logutil import add_verbosity_flags, setup_logging

# --strict's fix for each unconverged status
STRICT_HINTS = {
    "max_iters": "raise --max-iters (or --mc-iters for vegas), or loosen --rel-tol",
    "capacity": "raise --capacity or loosen --rel-tol",
    "nonfinite": "the integrand produced NaN/Inf on this domain; check the "
    "integrand/theta for poles or overflow",
    "deadline": "raise --deadline-s / --max-evals or loosen the tolerance",
    "no_active": "the region population collapsed; loosen --rel-tol",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="genz_gaussian")
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--n-requests", type=int, default=32, help="random problems to sample")
    ap.add_argument(
        "--request", action="append", default=[], metavar="SPEC",
        help="explicit family spec (repeatable; overrides --n-requests)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rel-tol", type=float, default=1e-6)
    ap.add_argument(
        "--rel-tols",
        default=None,
        metavar="TOL[,TOL...]",
        help="per-request tolerances, cycled over the fleet (e.g. '1e-2,1e-8' "
        "stripes easy and hard problems across slots)",
    )
    ap.add_argument("--capacity", type=int, default=1 << 12)
    ap.add_argument("--batch-slots", type=int, default=16)
    ap.add_argument("--admit-every", type=int, default=1)
    ap.add_argument("--eval-window-min", type=int, default=256)
    ap.add_argument(
        "--advance-window", action=argparse.BooleanOptionalAction, default=True,
        help="window the slot-batched advance too (the same bits)",
    )
    ap.add_argument(
        "--rule", default="genz_malik", choices=["genz_malik", "gauss_kronrod"],
        help="cubature rule of every slot (Gauss-Kronrod: d <= 6)",
    )
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument(
        "--devices", type=int, default=1,
        help="ranks the slots are spread over (0 = one per visible GPU)",
    )
    ap.add_argument("--rebalance", choices=("ring", "off"), default="ring")
    ap.add_argument(
        "--max-state-bytes", type=int, default=2 << 30,
        help="refuse fleets whose stacked region stores exceed this many bytes",
    )
    ap.add_argument("--validate", action="store_true", help="print true error vs analytic exact")
    ap.add_argument("--deadline-s", type=float, default=None, help="per-request wall-clock SLO")
    ap.add_argument("--max-evals", type=float, default=None, help="per-request evaluation SLO")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument(
        "--backend", default="cubature", choices=("cubature", "vegas", "auto"),
        help="engine pool: cubature, the VEGAS pool (single rank), or auto (by dimension)",
    )
    ap.add_argument("--mc-samples", type=int, default=8192, help="vegas samples per iteration")
    ap.add_argument("--mc-iters", type=int, default=100, help="vegas iteration cap")
    ap.add_argument("--mc-seed", type=int, default=0, help="vegas seed (same seed, same bits)")
    ap.add_argument(
        "--graceful", action="store_true",
        help="re-route capacity/nonfinite evictions once to a VEGAS pool and retry "
        "max_iters requests at a loosened tolerance (results carry provenance)",
    )
    ap.add_argument(
        "--checkpoint-dir", default=None,
        help="directory for service snapshots (engine state + slot map)",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=1,
        help="snapshot every N admission ticks (needs --checkpoint-dir)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="restore the latest snapshot in --checkpoint-dir and replay: "
        "already-pulled requests are skipped, in-flight slots resume "
        "mid-refinement (bit-identical for slots the crash did not touch)",
    )
    ap.add_argument(
        "--chaos-fail-device", default=None, metavar="DEV:TICK[:RESTORE]",
        help="inject a permanent device loss: rank DEV fails at iteration TICK "
        "(optionally healing at iteration RESTORE, so the ranks regrow): "
        "exercises the watchdog, evacuation and shrink",
    )
    ap.add_argument(
        "--max-dispatch-retries", type=int, default=2,
        help="transient dispatch faults retried (with backoff) before the "
        "faulting rank is declared permanently lost",
    )
    ap.add_argument(
        "--dispatch-timeout-s", type=float, default=None,
        help="watchdog timeout per dispatch: a wedged rank surfaces as a "
        "DispatchTimeout instead of hanging the serve loop",
    )
    add_telemetry_flags(ap)
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 unless every result is finite and converged; runs that "
        "completed only through an evacuation or a retry exit 0 but log a "
        "degraded-mode warning with each request's provenance",
    )
    add_pallas_flags(ap)
    add_verbosity_flags(ap)
    args = ap.parse_args(argv)
    refuse_pallas_flags(ap, args)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    log = setup_logging(quiet=args.quiet, verbose=args.verbose)

    import numpy as np
    import torch

    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import get_param, parse_spec
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.service import (
        BatchScheduler,
        GracefulScheduler,
        QuadRequest,
        ServiceCheckpointer,
    )
    from repro_torch.service.batch_engine import estimate_state_bytes
    from repro_torch.service.faults import DeviceDown

    family = get_param(args.family)
    cfg = QuadratureConfig(
        d=args.d,
        integrand=args.family,
        rel_tol=args.rel_tol,
        capacity=args.capacity,
        batch_slots=args.batch_slots,
        admit_every=args.admit_every,
        eval_window_min=args.eval_window_min,
        advance_window=args.advance_window,
        rule=args.rule,
        max_iters=args.max_iters,
        backend=args.backend,
        mc_samples=args.mc_samples,
        mc_max_iters=args.mc_iters,
        mc_seed=args.mc_seed,
        sync_every=args.sync_every,
        service_devices=args.devices,
        rebalance=args.rebalance,
    )
    vegas = cfg.resolved_backend() == "vegas"
    if vegas and args.devices not in (0, 1):
        raise SystemExit(
            "--backend vegas serves through a single-device pool (MC parallelism "
            "shards samples, not slots: see repro_torch.mc.multi_device); drop --devices"
        )
    # fail fast on fleets the stores cannot hold: they are allocated up front
    # (the VEGAS pool's state is a grid and counts per slot: no check)
    need = 0 if vegas else estimate_state_bytes(cfg, family)
    if need > args.max_state_bytes:
        raise SystemExit(
            f"--batch-slots {args.batch_slots} x --capacity {args.capacity} needs "
            f"~{need / 2**30:.2f} GiB of region-store state, over the "
            f"{args.max_state_bytes / 2**30:.2f} GiB limit; lower --batch-slots or "
            "--capacity (or raise --max-state-bytes)"
        )
    n_ranks = 1 if vegas else args.devices
    if args.device == "cpu":
        devices = ["cpu"] * max(n_ranks, 1)
    else:
        devices = cuda_devices(n_ranks or torch.cuda.device_count())
    if args.batch_slots % len(devices):
        raise SystemExit(
            f"--batch-slots {args.batch_slots} must be a multiple of the "
            f"{len(devices)} ranks: each rank owns batch_slots / ranks slots"
        )

    if args.request:
        thetas = []
        for spec in args.request:
            req_family, theta = parse_spec(spec)
            if req_family.name != family.name:
                raise SystemExit(
                    f"--request {spec!r} names family {req_family.name!r}, "
                    f"but --family is {args.family!r}"
                )
            thetas.append(theta)
    else:
        rng = np.random.default_rng(args.seed)
        thetas = [family.sample_theta(args.d, rng) for _ in range(args.n_requests)]
    rel_tols = [float(t) for t in args.rel_tols.split(",")] if args.rel_tols else None
    requests = [
        QuadRequest(
            req_id=i,
            theta=t,
            rel_tol=None if rel_tols is None else rel_tols[i % len(rel_tols)],
            deadline_s=args.deadline_s,
            max_evals=args.max_evals,
        )
        for i, t in enumerate(thetas)
    ]
    log.info(
        f"serving {len(requests)} x {family.name} (d={args.d}) through "
        f"{cfg.batch_slots} slots on {len(devices)} rank(s) {[str(d) for d in devices]} "
        f"(backend={cfg.resolved_backend()}, rule={cfg.rule}, rebalance={cfg.rebalance}"
        f"{', graceful' if args.graceful else ''})"
    )
    serve_kwargs = {
        "max_dispatch_retries": args.max_dispatch_retries,
        "dispatch_timeout_s": args.dispatch_timeout_s,
    }
    if args.checkpoint_dir:
        serve_kwargs["checkpointer"] = ServiceCheckpointer(args.checkpoint_dir)
        serve_kwargs["checkpoint_every"] = args.checkpoint_every
    if args.chaos_fail_device:
        parts = args.chaos_fail_device.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(
                f"--chaos-fail-device {args.chaos_fail_device!r}: expected "
                "DEV:TICK or DEV:TICK:RESTORE"
            )
        dev, tick = int(parts[0]), int(parts[1])
        restore = int(parts[2]) if len(parts) == 3 else None
        if not 0 <= dev < len(devices):
            raise SystemExit(
                f"--chaos-fail-device device {dev} out of range for {len(devices)} device(s)"
            )
        if len(devices) < 2:
            raise SystemExit(
                "--chaos-fail-device needs --devices >= 2: a single-device "
                "fleet has no surviving sub-mesh to evacuate onto"
            )
        serve_kwargs["fault_injector"] = DeviceDown(
            device=dev, at_tick=tick, restore_at_tick=restore
        )
        log.info(f"chaos: device {dev} fails at iteration {tick}"
                 + ("" if restore is None else f", heals at iteration {restore}"))
    telemetry = CliTelemetry(args)
    sched = (GracefulScheduler if args.graceful else BatchScheduler)(
        cfg, family, devices=devices, recorder=telemetry.recorder, **serve_kwargs)
    t0 = time.perf_counter()
    results = []
    for res in sched.serve(requests, resume=args.resume):
        results.append(res)
        line = res.summary()
        if args.validate:
            exact = family.exact(args.d, thetas[res.req_id])
            rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
            line += f" true_rel_err={rel:.2e}"
        log.info(f"[{len(results)}/{len(requests)}] {line}")
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = len(results)
    log.info(f"done: {n} problems in {dt:.2f}s ({n / dt:.1f} problems/sec)")
    log.info("stats: " + " ".join(f"{k}={v}" for k, v in sched.last_stats.items() if v))
    telemetry.finish(log.info)

    if args.strict:
        def finite(r):
            return math.isfinite(r.integral) and math.isfinite(r.error)

        problems = []
        for res in sorted(results, key=lambda r: r.req_id):
            if not finite(res):
                problems.append(
                    f"req {res.req_id}: non-finite result "
                    f"(integral={res.integral!r}, error={res.error!r})"
                )
            elif res.status != "converged":
                hint = STRICT_HINTS.get(res.status, "see the status taxonomy in DESIGN.md")
                problems.append(f"req {res.req_id}: status={res.status!r} (hint: {hint})")
            elif res.evacuated or res.attempts > 1:
                # converged after a recovery: the answer is right, the road
                # there was not; loud, with provenance, but not a failure
                log.warning(
                    f"STRICT-DEGRADED: req {res.req_id} converged after recovery "
                    f"(attempts={res.attempts}, retried_from={res.retried_from}, "
                    f"evacuated={res.evacuated})"
                )
        if problems:
            log.error("STRICT: " + "; ".join(problems))
            sys.exit(1)


if __name__ == "__main__":
    main()
