"""Multi-device adaptive quadrature (paper Fig. 1b) on per-rank states.

Each rank owns a fixed-capacity region store on its device and runs the
single-device iteration locally; three collectives per iteration make up
the paper's distributed extension:

  1. *metadata exchange*: ``psum`` of (integral, error, active count) right
     after evaluation, the paper's compact per-iteration summary and its
     only global synchronisation point;
  2. *classification with global context*: the equal-share classifier uses
     the GLOBAL active count, so all ranks finalise against the same
     threshold;
  3. *redistribution*: :func:`repro_torch.core.redistribution.redistribute`,
     cyclic donor/receiver pairing with capped coordinate-only payloads.

One host process drives every rank (see :mod:`repro_torch.core.ranks` for
why, and what it means on one card).  The host reads the metadata once per
iteration, for all ranks together, in one stacked read: with it come the
per-rank finalised counts, from which it knows every rank's population
(``split.next_population``) and so every window and every transfer size
without another sync.  ``cfg.sync_every`` therefore has no effect here (the
JAX package fuses that many iterations per dispatch); the results do not
depend on it.

The initial domain decomposition over-partitions:
``init_regions_per_device`` (paper default 8) boxes per rank, assigned
round-robin so that neighbouring boxes land on different ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import region_store
from repro_torch.core.adaptive import (
    AdaptiveResult,
    advance_ladder,
    advance_target,
    eval_ladder,
    make_eval_step,
)
from repro_torch.core.classify import classify
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.ranks import Ranks, cuda_devices
from repro_torch.core.redistribution import balance_stats, make_schedule, redistribute
from repro_torch.core.region_store import RegionState
from repro_torch.core.rules import make_rule
from repro_torch.core.split import classify_split_compact, next_population


@dataclasses.dataclass
class DistributedResult(AdaptiveResult):
    n_devices: int = 1
    # per-iteration history rows:
    #   (iter, integral, error, n_active, work_imbalance, max_rows)
    history: list = dataclasses.field(default_factory=list)
    # final per-rank evaluation counts (work distribution; Fig. 4b input)
    evals_per_device: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    # regions moved by redistribution, summed over all rounds
    moved: int = 0

    def mean_imbalance(self) -> float:
        if not self.history:
            return 0.0
        return float(np.mean([h[4] for h in self.history]))


def _initial_global_partition(cfg: QuadratureConfig, n_devices: int):
    """Over-decomposed initial partition, strided across ranks."""
    lo = np.asarray(cfg.lo(), np.float64)
    hi = np.asarray(cfg.hi(), np.float64)
    want = n_devices * cfg.init_regions_per_device
    # keep the "every axis split at least once" guarantee of the
    # single-device driver (see QuadratureConfig.n_init)
    want = max(want, min(2**cfg.d, n_devices * cfg.capacity // 4))
    n_init = 1 << (want - 1).bit_length()  # next power of two
    n_init = min(n_init, n_devices * (cfg.capacity // 4))
    centers, halfw = region_store.uniform_partition(lo, hi, n_init)
    return centers, halfw, n_init


def _initial_states(
    cfg: QuadratureConfig, ranks: Ranks, dtype: torch.dtype
) -> tuple[list[RegionState], list[int]]:
    """Per-rank initial states (box r on rank r mod n) and their counts.

    Each store is allocated on its rank's device; only the initial boxes
    are copied from the host.
    """
    n_devices = ranks.n
    centers, halfw, n_init = _initial_global_partition(cfg, n_devices)
    C, d = cfg.capacity, cfg.d
    per_dev = -(-n_init // n_devices)
    if per_dev > C // 2:
        raise ValueError("initial partition exceeds half the per-device store")

    states, counts = [], []
    for r, dev in enumerate(ranks.devices):
        mine = slice(r, n_init, n_devices)  # strided (paper: several regions/rank)
        k = len(centers[mine])
        st = region_store.empty_state(C, d, dtype, dev)
        st.centers[:k] = torch.as_tensor(centers[mine], dtype=dtype, device=dev)
        st.halfw[:k] = torch.as_tensor(halfw[mine], dtype=dtype, device=dev)
        st.active[:k] = True
        st.fresh[:k] = True
        states.append(st)
        counts.append(k)
    return states, counts


def integrate_distributed(
    cfg: QuadratureConfig,
    integrand=None,
    devices: Optional[Sequence] = None,
) -> DistributedResult:
    """Multi-rank integration, one host process for all ranks.

    ``devices`` lists one torch device per rank (a device may repeat, e.g.
    ``["cpu"] * 4``); the default is every visible CUDA device once, and it
    raises when there is none.

    Each iteration, in the JAX package's order: every rank evaluates its
    fresh regions; the estimates are summed over ranks; every rank
    classifies against the summed integral and the global active count and
    splits; one redistribution round runs; ``it`` is bumped.  The metrics
    are taken before the split.  The run stops when the error is within the
    budget, when no region is active, or at ``cfg.max_iters``; unlike
    :func:`repro_torch.core.adaptive.integrate`, ``iterations`` counts the
    iteration that converged too.
    """
    cfg = cfg.validate()
    if devices is None:
        devices = cuda_devices(torch.cuda.device_count())
    ranks = Ranks(devices)
    n = ranks.n

    lo = np.asarray(cfg.lo(), np.float64)
    hi = np.asarray(cfg.hi(), np.float64)
    total_volume = float(np.prod(hi - lo))
    rule = make_rule(cfg, integrand, device=ranks.first)
    schedule = make_schedule(n)
    dt = getattr(torch, cfg.dtype)
    states, n_loc = _initial_states(cfg, ranks, dt)
    widths = [torch.as_tensor(hi - lo, device=dev) for dev in ranks.devices]
    ladder = eval_ladder(cfg)
    adv_ladder = advance_ladder(cfg)
    C = cfg.capacity
    limit = 3 * C // 4

    history = []
    moved = 0
    converged = False
    integral = error = 0.0
    n_active = 0
    it = 0
    syncs = 0
    while it < cfg.max_iters:
        # --- evaluate (window from the rank's local count) -------------------
        works, ests, errs, acts = [], [], [], []
        for r, st in enumerate(states):
            works.append(torch.sum(st.active & st.fresh))
            st = make_eval_step(cfg, rule, window=region_store.select_window(ladder, n_loc[r]))(st)
            states[r] = st
            i_loc, e_loc = st.global_estimates(
                window=region_store.select_window(adv_ladder, n_loc[r])
            )
            ests.append(i_loc)
            errs.append(e_loc)
            acts.append(torch.sum(st.active))

        # --- metadata exchange (the only global sync point) -------------------
        integral_t = ranks.psum(ests)
        error_t = ranks.psum(errs)
        n_global_t = ranks.psum(acts)
        work_sum, work_max = ranks.psum(works), ranks.pmax(works)

        # --- classify (global equal-share threshold; local advance window) ----
        fins, windows, n_fin = [], [], []
        for r, st in enumerate(states):
            w = region_store.select_window(adv_ladder, advance_target(n_loc[r], C))
            ww = None if w == C else w
            sl = slice(None) if ww is None else slice(0, ww)
            fin = classify(
                cfg,
                st.est[sl],
                st.err[sl],
                st.halfw[sl],
                st.active[sl],
                integral_t.to(st.est.device, non_blocking=True),
                total_volume,
                widths[r],
                n_active=n_global_t.to(st.est.device, non_blocking=True),
            )
            fins.append(fin)
            windows.append(ww)
            n_fin.append(torch.sum(fin))
        synced = ranks.gather(
            [x.double() for x in [integral_t, error_t, work_sum, work_max, *n_fin]]
        ).tolist()
        syncs += 1
        integral, error = synced[0], synced[1]
        work_sum_h, work_max_h = int(synced[2]), int(synced[3])
        n_active = sum(n_loc)
        work_imb = (
            1.0 - (work_sum_h / n) / max(work_max_h, 1) if work_max_h > 0 else 0.0
        )
        if dt == torch.float32:
            work_imb = float(np.float32(work_imb))
        max_rows, _, _ = balance_stats(n_loc)

        # --- split, then the decentralised redistribution ----------------------
        for r, st in enumerate(states):
            states[r] = classify_split_compact(st, fins[r], window=windows[r])
        n_loc = [next_population(n_loc[r] - int(synced[4 + r]), C) for r in range(n)]
        if cfg.redistribution != "off":
            before = n_loc
            states, n_loc = redistribute(
                states, ranks, schedule=schedule, cap=cfg.message_cap,
                limit=limit, it=it, n_rows=n_loc,
            )
            moved += sum(max(b - a, 0) for a, b in zip(n_loc, before))
        for st in states:
            st.it += 1  # in place, on the device
        history.append((it, integral, error, n_active, work_imb, max_rows))
        it += 1

        budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
        if error <= budget:
            converged = True
            break
        if n_active == 0:
            break

    final = ranks.gather(
        [st.n_evals.double() for st in states] + [st.overflowed.double() for st in states]
    ).tolist()
    syncs += 1
    evals_per_device = np.asarray(final[:n], np.float64)
    overflowed = any(final[n:])
    if converged:
        status = "converged"
    elif overflowed:
        status = "capacity"
    elif n_active == 0:
        status = "no_active"
    else:
        status = "max_iters"

    return DistributedResult(
        integral=integral,
        error=error,
        status=status,
        iterations=it,
        n_evals=float(np.sum(evals_per_device)),
        n_active=n_active,
        overflowed=overflowed,
        host_syncs=syncs,
        n_devices=n,
        history=history,
        evals_per_device=evals_per_device,
        moved=moved,
    )
