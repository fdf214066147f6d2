"""Multi-rank self-test of the port, with one JSON blob on the last line.

    PYTHONPATH=src python -m repro_torch.core.dist_selftest [n_ranks] [cpu|cuda]

Runs the JAX package's self-test cases (``repro.core.dist_selftest``)
through :func:`repro_torch.core.distributed.integrate_distributed` with and
without redistribution, and :func:`repro_torch.core.adaptive.integrate` on
the first rank's device.  The ranks run on the CPU (``cpu``) or on the
visible GPUs (``cuda``, the default: rank r on cuda:(r mod count)); one host
process drives them all, so no device count has to be forced.
"""

import json
import sys


def main() -> None:
    n_ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    kind = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    if kind not in ("cpu", "cuda"):
        raise SystemExit(f"device must be cpu or cuda, got {kind!r}")

    from repro_torch.core import integrands
    from repro_torch.core.adaptive import integrate
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.core.distributed import integrate_distributed
    from repro_torch.core.ranks import cuda_devices

    devices = ["cpu"] * n_ranks if kind == "cpu" else cuda_devices(n_ranks)
    out = {"n_devices": n_ranks, "device": kind, "cases": []}
    cases = [
        ("f4", 4, 1e-6),
        ("f2", 3, 1e-6),
        ("f6", 3, 1e-5),
        ("f1", 4, 1e-6),
    ]
    for name, d, tol in cases:
        cfg = QuadratureConfig(
            d=d, integrand=name, rel_tol=tol, capacity=1 << 13, max_iters=200
        )
        single = integrate(cfg, device=devices[0])
        dist = integrate_distributed(cfg, devices=devices)
        off = integrate_distributed(
            QuadratureConfig(**{**cfg.__dict__, "redistribution": "off"}),
            devices=devices,
        )
        exact = integrands.get(name).exact(d)
        out["cases"].append(
            {
                "integrand": name,
                "d": d,
                "rel_tol": tol,
                "exact": exact,
                "single": {"I": single.integral, "status": single.status},
                "dist": {
                    "I": dist.integral,
                    "eps": dist.error,
                    "status": dist.status,
                    "iters": dist.iterations,
                    "n_evals": dist.n_evals,
                    "mean_imbalance": dist.mean_imbalance(),
                    "evals_per_device": dist.evals_per_device.tolist(),
                },
                "dist_noredist": {
                    "I": off.integral,
                    "status": off.status,
                    "mean_imbalance": off.mean_imbalance(),
                },
            }
        )

    print("RESULT_JSON:" + json.dumps(out))


if __name__ == "__main__":
    main()
