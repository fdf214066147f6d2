"""Multi-rank VEGAS: the sample shards of one integral spread over ranks.

The port of the JAX package's ``repro.mc.multi_device``.  MC is
embarrassingly parallel: no load balancing and no payload exchange.  Each
of ``n`` ranks (one host process drives them all, :mod:`repro_torch.core.ranks`)
draws, maps, evaluates and reduces ``mc_shards / n`` of the iteration's
fixed sample shards; the per-shard partial sums are gathered to the first
rank in shard order and combined in the engine's fixed left-to-right sum,
and the grid and counts are refined there and sent back to every rank.

Because shards, not raw sample ranges, are the unit of division, and a
shard's draws and sums are a function of the shard alone, the estimate is
**bit-identical to one rank at any rank count dividing ``mc_shards``**, on
one device type.  The self-test asserts it:

    PYTHONPATH=src python -m repro_torch.mc.multi_device [n_ranks] [cpu|cuda]
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.ranks import cuda_devices
from repro_torch.mc.engine import (
    VegasResult,
    drive,
    integrate_vegas,
    make_iterate,
    resolve_fn,
)
from repro_torch.telemetry.core import NULL


def integrate_vegas_distributed(
    cfg: QuadratureConfig,
    integrand: Optional[Callable] = None,
    devices: Optional[Sequence] = None,
    callback: Optional[Callable[[int, float, float, float], None]] = None,
    recorder=NULL,
) -> VegasResult:
    """VEGAS with the sample shards split over ``devices`` (one entry per
    rank, which may repeat a device; default one rank per visible GPU).

    Requires ``cfg.mc_shards % n_ranks == 0``.  The grid and counts (a few
    hundred KB) live on the first rank and go to the others each iteration;
    only the sample work is divided, which is where the time goes.
    ``recorder`` gets :func:`~repro_torch.mc.engine.drive`'s events.
    """
    cfg = cfg.validate()
    if devices is None:
        devices = cuda_devices(torch.cuda.device_count() if torch.cuda.is_available() else 1)
    devices = list(devices)
    fn = resolve_fn(cfg, integrand)
    if len(devices) == 1:
        return integrate_vegas(cfg, fn, callback, device=devices[0], recorder=recorder)
    if cfg.mc_shards % len(devices):
        raise ValueError(
            f"mc_shards={cfg.mc_shards} must be divisible by the rank count "
            f"({len(devices)}); shards are the unit of sample division"
        )
    iterate = make_iterate(cfg, fn, devices=devices)
    return drive(cfg, iterate, callback, device=devices[0], recorder=recorder)


def main() -> None:
    """Parity self-test: the JAX package's cases on one rank and on
    ``{2, n_ranks}`` ranks, asserting bit-identical integral, error,
    iterations and evaluations; prints one JSON blob."""
    import json
    import sys

    from repro_torch.core.integrands import get as get_integrand

    n_ranks = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    kind = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    if kind not in ("cpu", "cuda"):
        raise SystemExit(f"device must be cpu or cuda, got {kind!r}")
    devices = ["cpu"] * n_ranks if kind == "cpu" else cuda_devices(n_ranks)
    counts = sorted({2, n_ranks} - {1})
    out = {"n_devices": n_ranks, "device": kind, "device_counts": [1] + counts, "cases": []}
    cases = [
        ("genz_gaussian:5,5,5:0.5,0.3,0.7", 3, 1e-4),
        ("f6", 3, 1e-3),
        ("f4", 5, 1e-3),
    ]
    for name, d, tol in cases:
        cfg = QuadratureConfig(
            d=d, integrand=name, rel_tol=tol, backend="vegas", mc_samples=4096, mc_max_iters=30
        )
        single = integrate_vegas(cfg, device=devices[0])
        exact = get_integrand(name).exact(d)
        rec = {
            "integrand": name, "d": d, "integral": single.integral, "error": single.error,
            "status": single.status, "n_evals": single.n_evals, "chi2_dof": single.chi2_dof,
            "rel_err": abs(single.integral - exact) / max(abs(exact), 1e-300), "parity": [],
        }
        for p in counts:
            dist = integrate_vegas_distributed(cfg, devices=devices[:p])
            same = (dist.integral, dist.error, dist.n_evals, dist.iterations) == (
                single.integral, single.error, single.n_evals, single.iterations)
            rec["parity"].append({"devices": p, "integral": dist.integral,
                                  "error": dist.error, "bit_identical": same})
            assert same, (
                f"{name} d={d}: {p}-rank result diverged from one rank: "
                f"{dist.integral!r} vs {single.integral!r} (error {dist.error!r} "
                f"vs {single.error!r})"
            )
        out["cases"].append(rec)
    print("RESULT_JSON:" + json.dumps(out))


if __name__ == "__main__":
    main()
