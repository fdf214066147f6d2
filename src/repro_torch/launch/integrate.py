"""Quadrature launcher: the paper's solver as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 5 --rel-tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.integrate --devices 4 --integrand f6 --d 5
  PYTHONPATH=src python -m repro_torch.launch.integrate --device-loop --d 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.integrate --rule gauss_kronrod --d 3 --device cpu

Runs on the CUDA device unless ``--device cpu`` is given.  ``--devices N``
runs N ranks from this one process: rank r on cuda:(r mod device count), or
all on the CPU with ``--device cpu``.
"""

import argparse


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
        "--eval-window-min", type=int, default=256, help="smallest window ladder rung"
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
        help="iterations per host sync of --device-loop (no effect on the "
        "distributed driver, which syncs once per iteration)",
    )
    ap.add_argument(
        "--device-loop",
        action="store_true",
        help="device-resident driver (sync-every iterations per host sync)",
    )
    args = ap.parse_args(argv)

    from repro_torch.core.adaptive import integrate, integrate_device
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.integrands import get
    from repro_torch.core.ranks import cuda_devices

    cfg = QuadratureConfig(
        d=args.d,
        integrand=args.integrand,
        rel_tol=args.rel_tol,
        capacity=args.capacity,
        classifier=args.classifier,
        rule=args.rule,
        max_iters=args.max_iters,
        eval_window_min=args.eval_window_min,
        message_cap=args.message_cap,
        redistribution=args.redistribution,
        sync_every=args.sync_every,
    )
    if args.devices > 1:
        devices = (
            [args.device] * args.devices
            if args.device == "cpu"
            else cuda_devices(args.devices)
        )
        res = integrate_distributed(cfg, devices=devices)
        print(res.summary())
        print(f"devices={res.n_devices} mean_imbalance={res.mean_imbalance():.3f}")
    elif args.device_loop:
        res = integrate_device(cfg, device=args.device)
        print(res.summary())
    else:
        res = integrate(cfg, device=args.device)
        print(res.summary())
    exact = get(args.integrand).exact(args.d)
    rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
    print(f"exact={exact:.15e} true_rel_err={rel:.3e}")


if __name__ == "__main__":
    main()
