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

Runs on the CUDA device unless ``--device cpu`` is given; ``--devices N``
runs N ranks from this one process (rank r on cuda:(r mod device count)).
The flags of the service's other parts (checkpoints, chaos injection,
telemetry) are not ported yet and raise.
"""

import argparse
import time

# flags of parts not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "checkpoint_dir": "queue 1 item 7b (service checkpoints)",
    "checkpoint_every": "queue 1 item 7b (service checkpoints)",
    "resume": "queue 1 item 7b (service checkpoints)",
    "chaos_fail_device": "queue 1 item 7b (fault injection and the elastic mesh)",
    "trace": "queue 1 item 9 (observability)",
    "metrics": "queue 1 item 9 (observability)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="genz_gaussian")
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--n-requests", type=int, default=32, help="random problems to sample")
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
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--chaos-fail-device", default=None)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--metrics", default=None)
    args = ap.parse_args(argv)
    for name, item in NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"--{name.replace('_', '-')} is not ported yet (ROADMAP {item})")

    import numpy as np
    import torch

    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import get_param
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.service import BatchScheduler, GracefulScheduler, QuadRequest
    from repro_torch.service.batch_engine import estimate_state_bytes

    family = get_param(args.family)
    cfg = QuadratureConfig(
        d=args.d,
        integrand=args.family,
        rel_tol=args.rel_tol,
        capacity=args.capacity,
        batch_slots=args.batch_slots,
        admit_every=args.admit_every,
        eval_window_min=args.eval_window_min,
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
    print(
        f"serving {len(requests)} x {family.name} (d={args.d}) through "
        f"{cfg.batch_slots} slots on {len(devices)} rank(s) {[str(d) for d in devices]} "
        f"(backend={cfg.resolved_backend()}, rebalance={cfg.rebalance}"
        f"{', graceful' if args.graceful else ''})"
    )
    sched = (GracefulScheduler if args.graceful else BatchScheduler)(cfg, family, devices=devices)
    t0 = time.perf_counter()
    n = 0
    for res in sched.serve(requests):
        n += 1
        line = res.summary()
        if args.validate:
            exact = family.exact(args.d, thetas[res.req_id])
            rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
            line += f" true_rel_err={rel:.2e}"
        print(f"[{n}/{len(requests)}] {line}")
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"done: {len(requests)} problems in {dt:.2f}s ({len(requests) / dt:.1f} problems/sec)")
    print("stats: " + " ".join(f"{k}={v}" for k, v in sched.last_stats.items() if v))


if __name__ == "__main__":
    main()
