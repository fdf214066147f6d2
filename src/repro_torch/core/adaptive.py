"""Single-device batch-adaptive quadrature driver (paper Fig. 1a).

Every region whose error contribution is non-negligible is refined each
iteration (PAGANI-style batch adaptivity).  :func:`integrate` is the
host-driven loop: each iteration evaluates the fresh regions of the active
window, classifies, syncs three scalars to the host (the one sync of the
iteration), and then splits and compacts.  Windows are picked on the host
from the active count, which the host tracks exactly
(:func:`repro_torch.core.split.next_population`).

The device-resident driver of the JAX package (``integrate_device``) is not
ported yet: PyTorch has no ``while_loop``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import region_store
from repro_torch.core.classify import classify, nonfinite_mask
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.region_store import RegionState
from repro_torch.core.rules import make_rule
from repro_torch.core.split import classify_split_compact, next_population


@dataclasses.dataclass
class AdaptiveResult:
    integral: float
    error: float  # global error estimate (the paper's epsilon)
    status: str  # converged | max_iters | no_active | capacity | nonfinite
    iterations: int
    n_evals: float
    n_active: int
    overflowed: bool

    def summary(self) -> str:
        return (
            f"I={self.integral:.15e} eps={self.error:.3e} [{self.status}] "
            f"iters={self.iterations} evals={self.n_evals:.3g}"
        )


def resolve_device(device) -> torch.device:
    """The device to run on; CUDA unless the caller asks for the CPU.

    Raises when CUDA is asked for and absent: nothing carries on on the
    CPU unless the caller says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_eval_step(
    cfg: QuadratureConfig, rule, window: Optional[int] = None
) -> Callable[[RegionState], RegionState]:
    """Evaluate fresh regions, update per-region estimates + eval counter.

    ``window`` restricts the rule evaluation to the leading ``window`` rows
    (every fresh region lies in ``[0, n_active)``, so any
    ``window >= n_active`` gives the full-store result).  ``None`` evaluates
    the full store.  The store's arrays are updated in place.
    """

    def eval_step(state: RegionState) -> RegionState:
        w = state.capacity if window is None else min(window, state.capacity)
        need = state.active[:w] & state.fresh[:w]
        est, err, axis = rule.eval_batch(state.centers[:w], state.halfw[:w])
        state.est[:w] = torch.where(need, est, state.est[:w])
        state.err[:w] = torch.where(need, err, state.err[:w])
        state.axis[:w] = torch.where(need, axis, state.axis[:w])
        state.fresh.zero_()
        n_evals = (
            state.n_evals
            + torch.sum(need).to(state.n_evals.dtype) * rule.n_evals_per_region
        )
        return dataclasses.replace(state, n_evals=n_evals)

    return eval_step


def eval_ladder(cfg: QuadratureConfig) -> tuple[int, ...]:
    """The eval-window ladder, or the single full-capacity rung when the
    active-window path is disabled."""
    if not cfg.eval_window:
        return (cfg.capacity,)
    return region_store.window_ladder(cfg.capacity, cfg.eval_window_min)


def advance_ladder(cfg: QuadratureConfig) -> tuple[int, ...]:
    """The advance-window ladder: every other rung of the eval ladder from
    the top (x4-geometric), top rung always ``capacity``; the single
    full-capacity rung when ``cfg.advance_window`` is off."""
    if not cfg.advance_window:
        return (cfg.capacity,)
    full = region_store.window_ladder(cfg.capacity, cfg.eval_window_min)
    return tuple(sorted(full[::-2]))


def advance_target(n_active: int, capacity: int) -> int:
    """Row count the advance window must cover for an ``n_active`` population:
    ``min(2 * n_active, capacity)``, since splitting can double it."""
    return min(2 * int(n_active), capacity)


def classify_window(
    cfg: QuadratureConfig,
    state: RegionState,
    total_volume: float,
    domain_width: torch.Tensor,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global (integral, error) and the finalise mask over the leading
    ``window`` rows (the first half of the advance)."""
    sl = slice(None) if window is None else slice(0, window)
    integral, error = state.global_estimates(window=window)
    fin = classify(
        cfg,
        state.est[sl],
        state.err[sl],
        state.halfw[sl],
        state.active[sl],
        integral,
        total_volume,
        domain_width,
    )
    return integral, error, fin


def make_advance_step(
    cfg: QuadratureConfig,
    total_volume: float,
    domain_width,
    window: Optional[int] = None,
) -> Callable[..., RegionState]:
    """Classify (finalise negligible) + split survivors + compact.

    ``window`` runs the whole advance on the leading ``window`` rows;
    bit-identical to the full advance whenever
    ``window >= advance_target(n_active, capacity)``.
    """
    w = None if window is None else min(int(window), cfg.capacity)

    def advance(state: RegionState) -> RegionState:
        width = torch.as_tensor(domain_width, device=state.centers.device)
        _, _, fin = classify_window(cfg, state, total_volume, width, w)
        state = classify_split_compact(state, fin, window=w)
        return dataclasses.replace(state, it=state.it + 1)

    return advance


def quarantine_step(state: RegionState):
    """Zero + deactivate non-finite regions, recompute global estimates.

    The recovery path of the host driver, run at most once per problem
    (it ends with status ``nonfinite``).  The mid-store deactivations may
    break the compaction invariant, which is safe because nothing windowed
    runs afterwards.
    """
    bad = nonfinite_mask(state.est, state.err, state.active)
    zero = torch.zeros_like(state.est)
    state = dataclasses.replace(
        state,
        est=torch.where(bad, zero, state.est),
        err=torch.where(bad, zero, state.err),
        active=state.active & ~bad,
    )
    integral, error = state.global_estimates()
    return state, integral, error, torch.sum(state.active)


def result_status(
    converged: bool,
    n_active: int,
    it: int,
    cfg,
    overflowed: bool,
    nonfinite: bool = False,
) -> str:
    """Terminal-status taxonomy.  ``nonfinite`` wins over everything: the
    quarantined volume is unaccounted for, so ``converged`` would overstate
    what the estimate covers."""
    if nonfinite:
        return "nonfinite"
    if converged:
        return "converged"
    if overflowed:
        return "capacity"
    if n_active == 0:
        return "no_active"
    if it >= cfg.max_iters:
        return "max_iters"
    return "running"


def _setup(cfg: QuadratureConfig, integrand, device: torch.device):
    cfg = cfg.validate()
    lo = np.asarray(cfg.lo(), np.float64)
    hi = np.asarray(cfg.hi(), np.float64)
    total_volume = float(np.prod(hi - lo))
    dtype = getattr(torch, cfg.dtype)
    rule = make_rule(cfg, integrand, device=device)
    state = region_store.init_state(
        cfg.capacity, lo, hi, cfg.resolved_n_init(), dtype, device
    )
    return cfg, lo, hi, total_volume, rule, state


def integrate(
    cfg: QuadratureConfig,
    integrand=None,
    callback: Optional[Callable[[int, float, float, int], None]] = None,
    device="cuda",
) -> AdaptiveResult:
    """Host-driven adaptive integration, one host sync per iteration.

    ``integrand`` overrides ``cfg.integrand`` (a registry entry, or on the
    CPU any torch callable ``f(x)``).  ``callback(it, integral, error,
    n_active)`` is called once per evaluate step.
    """
    device = resolve_device(device)
    cfg, lo, hi, total_volume, rule, state = _setup(cfg, integrand, device)
    width = torch.as_tensor(hi - lo, device=device)
    ladder = eval_ladder(cfg)
    adv_ladder = advance_ladder(cfg)
    C = cfg.capacity

    converged = False
    nonfinite = False
    integral = error = 0.0
    n_active = cfg.resolved_n_init()
    it = 0
    for _ in range(cfg.max_iters):
        eval_w = region_store.select_window(ladder, n_active)
        state = make_eval_step(cfg, rule, window=eval_w)(state)
        w = region_store.select_window(adv_ladder, advance_target(n_active, C))
        ww = None if w == C else w
        # The classify half of the advance runs before the sync, so that
        # the host learns the finalised count with the estimates and can
        # size the next window without a second sync.
        integral_t, error_t, fin = classify_window(
            cfg, state, total_volume, width, ww
        )
        synced = torch.stack(
            [integral_t.double(), error_t.double(), fin.sum().double()]
        ).tolist()
        integral, error, n_fin = synced[0], synced[1], int(synced[2])
        if callback is not None:
            callback(it, integral, error, n_active)
        if not (math.isfinite(integral) and math.isfinite(error)):
            # an integrand NaN/Inf reached the global reductions: quarantine
            # the offending regions and stop with the best-effort estimate
            # of the surviving population (terminal status "nonfinite")
            state, gi, ge, na = quarantine_step(state)
            integral, error, n_active = float(gi), float(ge), int(na)
            nonfinite = True
            break
        budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
        if error <= budget:
            converged = True
            break
        if n_active == 0:
            break
        state = classify_split_compact(state, fin, window=ww)
        state.it += 1  # in place, on the device
        it += 1
        n_active = next_population(n_active - n_fin, C)

    overflowed = bool(state.overflowed)
    return AdaptiveResult(
        integral=integral,
        error=error,
        status=result_status(converged, n_active, it, cfg, overflowed, nonfinite),
        iterations=it,
        n_evals=float(state.n_evals),
        n_active=n_active,
        overflowed=overflowed,
    )
