"""Quadrature launcher: the paper's solver as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 5 --rel-tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.integrate --devices 4 --integrand f6 --d 5
  PYTHONPATH=src python -m repro_torch.launch.integrate --device-loop --d 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.integrate --rule gauss_kronrod --d 3 --device cpu

High dimension through the VEGAS Monte Carlo backend; a bare family name
samples one theta from --theta-seed:
  PYTHONPATH=src python -m repro_torch.launch.integrate --backend vegas --d 10 \\
      --integrand genz_gaussian --rel-tol 1e-3 --device cpu

Telemetry: a Chrome trace, the event stream and the summary table, checked
afterwards by the telemetry checker; --strict exits 1 unless the result is
finite and converged:
  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 3 --device cpu \
      --trace /tmp/t.json --metrics /tmp/m.jsonl --telemetry-summary --strict
  PYTHONPATH=src python -m repro_torch.telemetry.check --trace /tmp/t.json --metrics /tmp/m.jsonl

Runs on the CUDA device unless ``--device cpu`` is given.  ``--devices N``
runs N ranks from this one process: rank r on cuda:(r mod device count), or
all on the CPU with ``--device cpu``; with VEGAS the ranks split the sample
shards (the result is bit-identical to one rank).  The JAX CLI's
``--use-kernel`` and ``--interpret`` (its Pallas path) are refused: the
device picks the path here.
"""

import argparse
import math
import sys

from repro_torch.telemetry.flags import (
    CliTelemetry,
    add_pallas_flags,
    add_telemetry_flags,
    refuse_pallas_flags,
)

# --strict's fix for each unconverged status
STRICT_HINTS = {
    "max_iters": "raise --max-iters (or --mc-iters for vegas), or loosen --rel-tol",
    "capacity": "raise --capacity or loosen --rel-tol",
    "nonfinite": "the integrand produced NaN/Inf on this domain; check the "
    "integrand/theta for poles or overflow",
    "no_active": "the region population collapsed; loosen --rel-tol",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--integrand", default="f4")
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--rel-tol", type=float, default=1e-7)
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--classifier", default="robust", choices=["robust", "aggressive"])
    ap.add_argument("--rule", default="genz_malik", choices=["genz_malik", "gauss_kronrod"])
    ap.add_argument("--max-iters", type=int, default=600)
    ap.add_argument(
        "--block-regions", type=int, default=0,
        help="GM kernel lanes per block (0 = default)",
    )
    ap.add_argument(
        "--eval-window", action=argparse.BooleanOptionalAction, default=True,
        help="evaluate only the leading active window of the region store",
    )
    ap.add_argument(
        "--eval-window-min", type=int, default=256, help="smallest window ladder rung"
    )
    ap.add_argument(
        "--advance-window", action=argparse.BooleanOptionalAction, default=True,
        help="window the advance stage (classify, split and compact, the global "
        "reductions) as well: the same bits, the whole iteration scales with the "
        "live population",
    )
    ap.add_argument(
        "--backend",
        default="cubature",
        choices=["cubature", "vegas", "auto"],
        help="cubature (deterministic subdivision), vegas (adaptive "
        "importance-sampling MC for high d), or auto (picks by dimension)",
    )
    ap.add_argument("--mc-samples", type=int, default=8192, help="vegas samples per iteration")
    ap.add_argument("--mc-iters", type=int, default=100, help="vegas iteration cap")
    ap.add_argument("--mc-seed", type=int, default=0, help="vegas seed (same seed, same bits)")
    ap.add_argument(
        "--theta-seed",
        type=int,
        default=0,
        help="theta draw for a bare family-name --integrand (e.g. 'genz_gaussian')",
    )
    ap.add_argument(
        "--device", default="cuda", help="cuda (default) or cpu (plain PyTorch path)"
    )
    ap.add_argument("--devices", type=int, default=1, help="ranks of a distributed run")
    ap.add_argument("--message-cap", type=int, default=512)
    ap.add_argument(
        "--redistribution",
        default="ring",
        choices=["ring", "off"],
        help="distributed load redistribution policy",
    )
    ap.add_argument(
        "--sync-every",
        type=int,
        default=4,
        help="iterations per host sync of --device-loop and of --devices N",
    )
    ap.add_argument(
        "--device-loop",
        action="store_true",
        help="device-resident driver (sync-every iterations per host sync)",
    )
    add_telemetry_flags(ap)
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 unless the result is finite and converged (for scripted runs: "
        "a NaN or a max_iters/capacity/nonfinite end must fail the pipeline)",
    )
    add_pallas_flags(ap)
    args = ap.parse_args(argv)
    refuse_pallas_flags(ap, args)

    import numpy as np

    from repro_torch.core.adaptive import integrate, integrate_device
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.integrands import PARAM_REGISTRY, get, to_spec
    from repro_torch.core.ranks import cuda_devices
    from repro_torch.mc import integrate_vegas, integrate_vegas_distributed

    integrand = args.integrand
    if integrand in PARAM_REGISTRY:
        # a bare family name: one theta, written as a spec so that the GM
        # kernel takes it as (family, theta) and the exact value follows
        family = PARAM_REGISTRY[integrand]
        integrand = to_spec(family, family.sample_theta(args.d, np.random.default_rng(args.theta_seed)))
    cfg = QuadratureConfig(
        d=args.d,
        integrand=integrand,
        rel_tol=args.rel_tol,
        capacity=args.capacity,
        classifier=args.classifier,
        rule=args.rule,
        max_iters=args.max_iters,
        block_regions=args.block_regions,
        eval_window=args.eval_window,
        eval_window_min=args.eval_window_min,
        advance_window=args.advance_window,
        backend=args.backend,
        mc_samples=args.mc_samples,
        mc_max_iters=args.mc_iters,
        mc_seed=args.mc_seed,
        message_cap=args.message_cap,
        redistribution=args.redistribution,
        sync_every=args.sync_every,
    )
    devices = None
    if args.devices > 1:
        devices = (
            [args.device] * args.devices
            if args.device == "cpu"
            else cuda_devices(args.devices)
        )
    telemetry = CliTelemetry(args)
    recorder = telemetry.recorder
    if cfg.resolved_backend() == "vegas":
        if devices is not None:
            res = integrate_vegas_distributed(cfg, devices=devices, recorder=recorder)
            print(res.summary())
            print(f"devices={len(devices)} (sample shards split over the ranks)")
        else:
            res = integrate_vegas(cfg, device=args.device, recorder=recorder)
            print(res.summary())
    elif devices is not None:
        res = integrate_distributed(cfg, devices=devices, recorder=recorder)
        print(res.summary())
        print(f"devices={res.n_devices} mean_imbalance={res.mean_imbalance():.3f} "
              f"host_syncs={res.host_syncs}")
    elif args.device_loop:
        res = integrate_device(cfg, device=args.device, recorder=recorder)
        print(res.summary())
    else:
        res = integrate(cfg, device=args.device, recorder=recorder)
        print(res.summary())
    telemetry.finish(print)
    exact = get(integrand).exact(args.d)
    rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
    print(f"exact={exact:.15e} true_rel_err={rel:.3e}")

    if args.strict:
        problems = []
        if not (math.isfinite(res.integral) and math.isfinite(res.error)):
            problems.append(
                f"non-finite result (integral={res.integral!r}, error={res.error!r})"
            )
        if res.status != "converged":
            hint = STRICT_HINTS.get(res.status, "see the status taxonomy in DESIGN.md")
            problems.append(f"status={res.status!r} (hint: {hint})")
        if problems:
            print("STRICT: " + "; ".join(problems), file=sys.stderr)
            sys.exit(1)


if __name__ == "__main__":
    main()
