"""Heuristic region classifier: finalise regions with negligible error.

Two modes, mirroring the paper's single-GPU comparison:

- ``robust``: a region is finalised when its error estimate fits inside an
  equal 1/4-safety share of the global error budget;
- ``aggressive`` (PAGANI-like): a region is finalised when its error is
  small relative to its own integral estimate (plus the same floor).

Numerical guards (Gander-Gautschi) apply in both modes: a region whose
width has collapsed to the resolution floor, or whose error sits at the
round-off noise floor, is finalised regardless.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.genz_malik import row_prod


def error_budget(cfg: QuadratureConfig, global_estimate: torch.Tensor) -> torch.Tensor:
    """The paper's stopping threshold: max(abs_tol, |I| * rel_tol)."""
    return torch.clamp(torch.abs(global_estimate) * cfg.rel_tol, min=cfg.abs_tol)


def nonfinite_mask(
    est: torch.Tensor, err: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """Mask of active regions whose estimates went non-finite (NaN/Inf)."""
    return active & ~(torch.isfinite(est) & torch.isfinite(err))


def classify(
    cfg: QuadratureConfig,
    est: torch.Tensor,
    err: torch.Tensor,
    halfw: torch.Tensor,
    active: torch.Tensor,
    global_estimate: torch.Tensor,
    total_volume: float,
    domain_width: torch.Tensor,
    n_active: torch.Tensor | None = None,
    budget: torch.Tensor | None = None,
    rel_tol: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Return the mask of active regions to finalise this iteration.

    The region axis is the last of ``est``, ``err`` and ``active`` (the
    second last of ``halfw``); leading axes are problems of a stacked store
    (the batch service), each classified on its own.  ``n_active`` defaults
    to the local active count of each problem.  ``budget`` and ``rel_tol``
    override the config-derived error budget and relative tolerance
    (``rel_tol`` only affects the aggressive classifier); with leading axes
    they carry them, with a trailing axis of size 1.
    """
    if budget is None:
        budget = error_budget(cfg, global_estimate)
    if rel_tol is None:
        rel_tol = cfg.rel_tol
    vol = row_prod((2.0 * halfw).movedim(-1, 0))
    if n_active is None:
        n_active = torch.sum(active, dim=-1, keepdim=True)
    n_active = torch.clamp(n_active, min=1)

    share = 0.25 * budget / n_active.to(err.dtype)
    if cfg.classifier == "robust":
        small = err <= share
    else:  # aggressive, PAGANI-like: prune relative to the LOCAL estimate
        small = err <= torch.maximum(rel_tol * torch.abs(est), share)

    # minimum refinement depth before a region may be finalised (see
    # QuadratureConfig.min_depth_per_axis)
    deep = vol <= total_volume / 2.0 ** (cfg.min_depth_per_axis * cfg.d) * (
        1.0 + 1e-12
    )
    small = small & deep

    # --- numerical guards ----------------------------------------------------
    eps = torch.finfo(est.dtype).eps
    width_floor = torch.any(
        halfw <= cfg.min_width_frac * domain_width[None, :], dim=-1
    )
    noise = err <= cfg.noise_mult * eps * (torch.abs(est) + vol)
    guard = width_floor | noise

    return active & (small | guard)
