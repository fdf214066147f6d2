"""Quadrature launcher: the paper's solver on one device, as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 5 --rel-tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.integrate --integrand f4 --d 3 --device cpu

Runs on the CUDA device unless ``--device cpu`` is given.
"""

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--integrand", default="f4")
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--rel-tol", type=float, default=1e-7)
    ap.add_argument("--capacity", type=int, default=1 << 15)
    ap.add_argument("--classifier", default="robust", choices=["robust", "aggressive"])
    ap.add_argument("--max-iters", type=int, default=600)
    ap.add_argument(
        "--eval-window-min", type=int, default=256, help="smallest window ladder rung"
    )
    ap.add_argument(
        "--device", default="cuda", help="cuda (default) or cpu (plain PyTorch path)"
    )
    args = ap.parse_args(argv)

    from repro_torch.core.adaptive import integrate
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.integrands import get

    cfg = QuadratureConfig(
        d=args.d,
        integrand=args.integrand,
        rel_tol=args.rel_tol,
        capacity=args.capacity,
        classifier=args.classifier,
        max_iters=args.max_iters,
        eval_window_min=args.eval_window_min,
    )
    res = integrate(cfg, device=args.device)
    print(res.summary())
    exact = get(args.integrand).exact(args.d)
    rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
    print(f"exact={exact:.15e} true_rel_err={rel:.3e}")


if __name__ == "__main__":
    main()
