"""Batch quadrature service on the PyTorch/CUDA port: one engine serving a
fleet of integrals.

The JAX example's program (``examples/batch_service.py``) on
``repro_torch``: a parameter sweep of exp(-sum a_i^2 (x_i - u_i)^2) over
[0,1]^3 for 24 random (a, u) draws, through 8 slots (one GM launch per
iteration over every live slot), in the offline ``integrate_batch`` form
and the streaming ``serve`` form, both checked against the analytic
Genz-Gaussian value.

Run: PYTHONPATH=src python examples/torch_batch_service.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import get_param
from repro_torch.service import QuadRequest, integrate_batch, serve


def _worst(results, thetas, family, d) -> float:
    """Largest |I - exact| / max(error, budget) over the fleet: the
    service's bar is 10 (tests/test_service.py)."""
    worst = 0.0
    for r, t in zip(results, thetas):
        exact = family.exact(d, t)
        budget = max(r.error, abs(exact) * 1e-6)
        worst = max(worst, abs(r.integral - exact) / budget)
    return worst


def main(device: str = "cuda") -> dict:
    """Both forms; returns their results and each one's worst true
    relative error and worst error against the service's bar."""
    family = get_param("genz_gaussian")
    d = 3
    cfg = QuadratureConfig(
        d=d,
        integrand="genz_gaussian",
        rel_tol=1e-6,
        capacity=1 << 12,
        batch_slots=8,  # 24 problems stream through 8 slots
    )
    rng = np.random.default_rng(0)
    thetas = [family.sample_theta(d, rng) for _ in range(24)]
    devices = [device]

    # offline form: results come back in submission order
    results = integrate_batch(cfg, thetas, devices=devices)
    worst = max(
        abs(r.integral - family.exact(d, t)) / abs(family.exact(d, t))
        for t, r in zip(thetas, results)
    )
    print(f"integrate_batch: {len(results)} problems, worst true rel err {worst:.2e}")
    for t, r in zip(thetas[:3], results[:3]):
        print(f"  a={np.array2string(t['a'], precision=2)}  {r.summary()}")
    print("  ...")

    # streaming form: results arrive in convergence order, slots are refilled
    # mid-flight (continuous batching) — watch admitted_at/finished_at
    reqs = (QuadRequest(req_id=i, theta=t) for i, t in enumerate(thetas))
    streamed = []
    for res in serve(cfg, reqs, family, devices=devices):
        streamed.append(res)
        print(
            f"serve: req {res.req_id:2d} admitted@{res.admitted_at:3d} "
            f"finished@{res.finished_at:3d} [{res.status}] I={res.integral:.9e}"
        )
    streamed.sort(key=lambda r: r.req_id)
    return dict(
        batch=results, served=streamed, rel_tol=cfg.rel_tol, worst_true_rel_err=worst,
        worst_vs_bar=max(_worst(results, thetas, family, d), _worst(streamed, thetas, family, d)),
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
