"""Quickstart on the PyTorch/CUDA port: adaptively integrate a sharp
Gaussian over [0,1]^5, then a function of your own.

The JAX quickstart's program (``examples/quickstart.py``) on
``repro_torch``: the registry's ``f4`` runs through the CUDA GM kernel, and
the "banana", a plain torch callable, through the GM rule's torch route on
the same card.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from repro_torch.core import QuadratureConfig, integrate
from repro_torch.core.integrands import get


def banana(x):  # Rosenbrock-like ridge: any torch f((d, N) coords) -> (N,)
    return torch.exp(-5.0 * (x[1] - x[0] ** 2) ** 2 - (1.0 - x[0]) ** 2)


def banana_exact() -> float:
    """The banana over [0,1]^2: the inner integral over x[1] in closed form
    (erf), the outer one by 200-point Gauss-Legendre, accurate to ~1e-15."""
    nodes, weights = np.polynomial.legendre.leggauss(200)
    total = 0.0
    for t, w in zip(nodes, weights):
        x = 0.5 * (t + 1.0)
        inner = math.sqrt(math.pi / 5.0) / 2.0 * (
            math.erf(math.sqrt(5.0) * (1.0 - x * x)) + math.erf(math.sqrt(5.0) * x * x))
        total += 0.5 * w * math.exp(-((1.0 - x) ** 2)) * inner
    return total


def main(device: str = "cuda") -> dict:
    """Both runs; returns each one's result, exact value, true relative
    error and tolerance."""
    out = {}
    # a registry integrand (the paper's f4) ...
    cfg = QuadratureConfig(d=5, integrand="f4", rel_tol=1e-6, capacity=1 << 16)
    res = integrate(cfg, device=device)
    exact = get("f4").exact(5)
    rel = abs(res.integral - exact) / exact
    print("f4, d=5:", res.summary())
    print(f"  exact={exact:.12e}  true rel err={rel:.2e}")
    out["f4"] = dict(result=res, exact=exact, true_rel_err=rel, rel_tol=cfg.rel_tol)

    # ... and a custom integrand: any torch f((d, N) coords) -> (N,)
    cfg = QuadratureConfig(d=2, rel_tol=1e-8, capacity=1 << 13)
    res = integrate(cfg, integrand=banana, device=device)
    exact = banana_exact()
    rel = abs(res.integral - exact) / exact
    print("custom banana, d=2:", res.summary())
    print(f"  exact={exact:.12e}  true rel err={rel:.2e}")
    out["banana"] = dict(result=res, exact=exact, true_rel_err=rel, rel_tol=cfg.rel_tol)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
