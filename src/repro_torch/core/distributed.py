"""Multi-device adaptive quadrature (paper Fig. 1b) on per-rank states.

Each rank owns a fixed-capacity region store on its device and runs the
single-device iteration locally; three collectives per iteration make up
the paper's distributed extension:

  1. *metadata exchange*: ``psum`` of (integral, error, active count) right
     after evaluation, the paper's compact per-iteration summary;
  2. *classification with global context*: the equal-share classifier uses
     the GLOBAL active count, so all ranks finalise against the same
     threshold;
  3. *redistribution*: :func:`repro_torch.core.redistribution.redistribute`,
     cyclic donor/receiver pairing with capped coordinate-only payloads,
     its counts and sizes on the devices.

One host process drives every rank (see :mod:`repro_torch.core.ranks` for
why, and what it means on one card).  As in the JAX package, ``cfg.sync_every``
iterations run per dispatch, with no host read inside one: each iteration
stacks a snapshot of its metadata on the first rank's device, and the host
reads a dispatch's snapshots once (see :func:`integrate_distributed`).

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
    LandedRows,
    advance_ladder,
    advance_target,
    eval_ladder,
    make_eval_step,
    stops,
)
from repro_torch.core.classify import classify
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.ranks import Ranks, cuda_devices
from repro_torch.core.redistribution import balance_stats, make_schedule, redistribute
from repro_torch.core.region_store import RegionState, to_device
from repro_torch.core.rules import make_rule
from repro_torch.core.split import classify_split_compact
from repro_torch.telemetry.core import NULL


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
    cfg: QuadratureConfig, ranks: Ranks, dtype: torch.dtype, recorder=NULL
) -> tuple[list[RegionState], list[int]]:
    """Per-rank initial states (box r on rank r mod n) and their counts.

    Each store is allocated on its rank's device; only the initial boxes
    are copied from the host, through pinned memory (no host wait).  The
    global partition is built inside a ``core.partition`` span.
    """
    n_devices = ranks.n
    with recorder.span("core.partition"):
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
        st.centers[:k] = to_device(centers[mine], dtype, dev)
        st.halfw[:k] = to_device(halfw[mine], dtype, dev)
        st.active[:k] = True
        st.fresh[:k] = True
        states.append(st)
        counts.append(k)
    return states, counts


def _round_limit(capacity: int) -> int:
    """A redistribution round fills no rank past this many rows."""
    return 3 * capacity // 4


def grow_bounds(bounds: list[int], cfg: QuadratureConfig) -> list[int]:
    """Upper bounds of the ranks' live counts one iteration on, from upper
    bounds of them now: a split at most doubles a rank's count (capped at
    the capacity), and a round's receive lifts it at most to the fair share
    of the doubled total, by at most ``cfg.message_cap`` and not past
    :func:`_round_limit`; a donor only loses rows."""
    C = cfg.capacity
    post = [min(2 * b, C) for b in bounds]
    if cfg.redistribution == "off" or len(bounds) <= 1:
        return post
    fair = sum(post) // len(bounds)
    return [max(p, min(p + cfg.message_cap, fair, _round_limit(C))) for p in post]


# Per-rank fields of one iteration's snapshot: the live count before the
# split, the fresh regions it evaluated, the regions it sent, its overflow
# flag (after the advance), its live count after the round and its
# evaluation count.
_PER_RANK = ("n_rows", "work", "sent", "overflowed", "after", "n_evals")


def _iterate(cfg, rule, ranks, states, counts, bounds, it, *, schedule, total_volume, widths,
             stopped, record, recorder=NULL):
    """One iteration on every rank, enqueued with no host read.

    ``counts`` are the per-rank live counts (int64 on each rank's device)
    and ``bounds`` host upper bounds of them, from which the windows are
    sized.  Returns the states, the counts after the round and the
    iteration's snapshot (float64, on the first rank's device): integral
    and error, then :data:`_PER_RANK` rank by rank; ``record(snapshot)``
    queues its copy to the host.  ``stopped()`` is asked before every
    rank's evaluate but the first, before the advance and before the round;
    once it holds, the iteration is abandoned and ``None`` returned, with
    nothing more enqueued.  ``recorder`` gets the stage spans
    (:func:`integrate_distributed`).
    """
    C = cfg.capacity
    ladder, adv_ladder = eval_ladder(cfg), advance_ladder(cfg)

    # --- evaluate (window from the rank's bound) ---------------------------
    works, ests, errs = [], [], []
    with recorder.span("dist.eval"):
        for r, st in enumerate(states):
            if r and stopped():
                return None
            w = region_store.select_window(ladder, bounds[r])
            works.append(torch.sum(st.active[:w] & st.fresh[:w]))
            st = states[r] = make_eval_step(cfg, rule, window=w)(st)
            i_loc, e_loc = st.global_estimates(
                window=region_store.select_window(adv_ladder, bounds[r])
            )
            ests.append(i_loc)
            errs.append(e_loc)

    # --- metadata exchange --------------------------------------------------
    with recorder.span("dist.exchange"):
        integral_t = ranks.psum(ests)
        error_t = ranks.psum(errs)
        n_global_t = ranks.psum(counts)

    # --- classify (global equal-share threshold) and split ------------------
    if stopped():
        return None
    post = []
    with recorder.span("dist.advance"):
        for r, st in enumerate(states):
            w = region_store.select_window(adv_ladder, advance_target(bounds[r], C))
            ww = None if w == C else w
            sl = slice(0, w)
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
            st = states[r] = classify_split_compact(st, fin, window=ww)
            post.append(torch.sum(st.active[:w]))

    # --- the decentralised redistribution ------------------------------------
    if stopped():
        return None
    if cfg.redistribution != "off":
        with recorder.span("dist.round"):
            states, after, sent = redistribute(
                states, ranks, schedule=schedule, cap=cfg.message_cap,
                limit=_round_limit(C), it=it, n_rows=post,
            )
    else:
        after, sent = post, [torch.zeros_like(p) for p in post]
    for st in states:
        st.it += 1  # in place, on the device

    # one float64 row a rank (stack promotes the counts and the flag; every
    # count is exact below 2^53)
    with recorder.span("dist.snapshot"):
        per_rank = ranks.gather([
            torch.stack([n, w, k, st.overflowed, a, st.n_evals.double()])
            for n, w, k, st, a in zip(counts, works, sent, states, after)
        ])
        snap = torch.cat([torch.stack([integral_t, error_t]).double(), per_rank.flatten()])
        record(snap)
    return states, after, snap


def integrate_distributed(
    cfg: QuadratureConfig,
    integrand=None,
    devices: Optional[Sequence] = None,
    recorder=NULL,
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

    The iterations run in dispatches of K = ``cfg.sync_every``, with no
    host read inside one (the JAX package's ``make_dist_step``):

    - each rank's windows are sized from an upper bound of its population:
      the newest exact count whose copy to pinned host memory has landed
      (:class:`repro_torch.core.adaptive.LandedRows`, as
      :func:`repro_torch.core.adaptive.integrate_device` does), grown for
      each iteration since: ×2 for the split, capped at the capacity, then
      for a receive up to the fair share of the grown total, by at most
      ``cfg.message_cap``.  Any window that covers the population gives
      the same bits (``region_store.tree_sum``), so the results do not
      depend on K, nor on whether a copy landed in time.  The windows'
      rows past the exact counts' windows are in ``eval_rows`` against
      ``eval_rows_exact``;
    - the redistribution round keeps its counts on the devices;
    - each iteration stacks a snapshot on the first rank's device and
      copies it to pinned host memory without a sync: the summed integral
      and error, and per rank the live count before the split, the fresh
      regions evaluated, the regions sent, ``overflowed``, the live count
      after the round and ``n_evals`` after the advance;
    - before each rank's evaluate, before the advance and before the round
      the host queries the snapshots' events: once a landed snapshot shows
      the stop (converged, or no active region) it enqueues nothing more,
      and the iteration under way is abandoned, as the reference's
      ``lax.cond`` skips every iteration after its on-device ``stop``;
    - the host reads the dispatch's snapshots once, sums the per-rank
      integers, and takes the first iteration that converged (or found no
      active region).  The iterations enqueued, in full or in part, after
      it and before its snapshot landed are discarded (``discarded``): the
      result comes from the snapshot, and the states are never read again.

    ``host_syncs`` is the number of dispatches.  ``recorder``
    (:mod:`repro_torch.telemetry`) gets the JAX package's events: a
    ``dist.dispatch`` span per dispatch (``executed`` = the iterations the
    host kept), and per kept iteration a ``dist.work_imb`` gauge, the very
    float of the ``history`` row, and a ``dist.iter`` instant, all from the
    values of the dispatch's one read.  It also gets the port's stage
    spans, each around one stage of every rank: a ``dist.init`` span around
    the set-up (holding ``core.partition``); per iteration ``dist.eval``
    (each rank's evaluate and local estimates), ``dist.exchange`` (the three
    psums), ``dist.advance`` (each rank's classify, compact and split),
    ``dist.round`` (the round) and ``dist.snapshot`` (the gather and the
    snapshot's copy); per dispatch a ``dist.read``.
    """
    cfg = cfg.validate()
    if devices is None:
        devices = cuda_devices(torch.cuda.device_count())
    with recorder.span("dist.init"):
        ranks = Ranks(devices)
        n = ranks.n

        lo = np.asarray(cfg.lo(), np.float64)
        hi = np.asarray(cfg.hi(), np.float64)
        total_volume = float(np.prod(hi - lo))
        rule = make_rule(cfg, integrand)
        schedule = make_schedule(n)
        dt = getattr(torch, cfg.dtype)
        states, n_host = _initial_states(cfg, ranks, dt, recorder)
        widths = [to_device(hi - lo, torch.float64, dev) for dev in ranks.devices]
        counts = [to_device(k, torch.int64, dev) for k, dev in zip(n_host, ranks.devices)]
    ladder = eval_ladder(cfg)

    def unpack(vals):  # a snapshot row as a dict, the per-rank fields as arrays
        per = np.asarray(vals[2:]).reshape(n, len(_PER_RANK))
        return dict(integral=vals[0], error=vals[1],
                    **{k: per[:, i] for i, k in enumerate(_PER_RANK)})

    def landed_stop(vals):
        row = unpack(vals)
        return stops(cfg, row["integral"], row["error"], row["n_rows"].sum())

    landed = LandedRows(cfg.sync_every, 2 + n * len(_PER_RANK), ranks.first, torch.float64,
                        stop=landed_stop)
    history = []
    moved = discarded = eval_rows = eval_rows_exact = 0
    row = None
    stop = False
    it = 0
    syncs = 0
    while it < cfg.max_iters and not stop:
        steps = min(cfg.sync_every, cfg.max_iters - it)
        with recorder.span("dist.dispatch", it=it) as sp:
            snaps, windows = [], []
            landed.start()
            for j in range(steps):
                if landed.stopped():
                    break
                m = landed.landed()
                bounds = [int(b) for b in unpack(landed.rows[m - 1])["after"]] if m else n_host
                for _ in range(j - m):
                    bounds = grow_bounds(bounds, cfg)
                done = _iterate(
                    cfg, rule, ranks, states, counts, bounds, it + j, schedule=schedule,
                    total_volume=total_volume, widths=widths, stopped=landed.stopped,
                    record=landed.record, recorder=recorder,
                )
                if done is None:  # abandoned at the landed stop
                    discarded += 1
                    break
                states, counts, snap = done
                windows.append([region_store.select_window(ladder, b) for b in bounds])
                snaps.append(snap)
            with recorder.span("dist.read"):
                rows = torch.stack(snaps).tolist()
            syncs += 1
            kept = []
            for vals, wins in zip(rows, windows):
                row = unpack(vals)
                eval_rows += sum(wins)
                eval_rows_exact += sum(
                    region_store.select_window(ladder, int(x)) for x in row["n_rows"])
                if not stop:
                    kept.append(row)
                    stop = stops(cfg, row["integral"], row["error"], row["n_rows"].sum())
            discarded += len(rows) - len(kept)
            sp["executed"] = len(kept)
        for row in kept:
            n_rows = [int(x) for x in row["n_rows"]]
            work_sum, work_max = int(row["work"].sum()), int(row["work"].max())
            work_imb = 1.0 - (work_sum / n) / max(work_max, 1) if work_max > 0 else 0.0
            if dt == torch.float32:
                work_imb = float(np.float32(work_imb))
            max_rows, _, _ = balance_stats(n_rows)
            row["n_active"] = sum(n_rows)
            if recorder.enabled:
                recorder.gauge("dist.work_imb", work_imb, it=it)
                recorder.event(
                    "dist.iter", it=it, integral=row["integral"], error=row["error"],
                    n_active=row["n_active"], max_rows=max_rows,
                )
            history.append((it, row["integral"], row["error"], row["n_active"], work_imb, max_rows))
            moved += int(row["sent"].sum())
            it += 1
        n_host = [int(x) for x in row["after"]]

    integral, error = (row["integral"], row["error"]) if row else (0.0, 0.0)
    n_active = row["n_active"] if row else 0
    evals_per_device = row["n_evals"].copy() if row else np.zeros(n)
    overflowed = bool(row["overflowed"].any()) if row else False
    budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
    if row and error <= budget:
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
        discarded=discarded,
        eval_rows=eval_rows,
        eval_rows_exact=eval_rows_exact,
    )
