"""Distributed adaptive quadrature with round-robin load redistribution,
on the PyTorch/CUDA port.

The JAX example's program (``examples/distributed_quadrature.py``) on
``repro_torch``: 8 ranks integrate a discontinuous integrand whose work
concentrates on a few of them, and the per-rank balance is printed with
redistribution ON and OFF.  One host process drives every rank (no
respawn): rank r runs on cuda:(r mod device count), so on one card the
ranks share it; with ``--device cpu`` the 8 ranks run on the CPU.

Run: PYTHONPATH=src python examples/torch_distributed_quadrature.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.distributed import integrate_distributed
from repro_torch.core.integrands import get
from repro_torch.core.ranks import cuda_devices

RANKS = 8


def main(device: str = "cuda") -> dict:
    """Both runs; returns each one's result, true relative error, mean work
    imbalance and tolerance by redistribution policy."""
    devices = ["cpu"] * RANKS if device == "cpu" else cuda_devices(RANKS)
    print(f"ranks: {RANKS} on {sorted({str(d) for d in devices})}")
    base = dict(d=4, integrand="f6", rel_tol=1e-6, capacity=1 << 13, max_iters=200)
    exact = get("f6").exact(4)
    out = {}
    for redis in ("ring", "off"):
        cfg = QuadratureConfig(redistribution=redis, **base)
        res = integrate_distributed(cfg, devices=devices)
        share = res.evals_per_device / max(res.n_evals, 1)
        rel = abs(res.integral - exact) / exact
        print(
            f"redistribution={redis:3}: {res.summary()}\n"
            f"   true rel err {rel:.2e}; "
            f"mean work imbalance {res.mean_imbalance():.3f}; "
            f"per-rank eval share {np.array2string(share, precision=3)}"
        )
        out[redis] = dict(result=res, true_rel_err=rel, rel_tol=cfg.rel_tol,
                          mean_imbalance=res.mean_imbalance())
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
