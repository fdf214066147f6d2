"""Single-device batch-adaptive quadrature driver (paper Fig. 1a).

Every region whose error contribution is non-negligible is refined each
iteration (PAGANI-style batch adaptivity).  :func:`integrate` is the
host-driven loop: each iteration evaluates the fresh regions of the active
window, classifies, syncs three scalars to the host (the one sync of the
iteration), and then splits and compacts.  Windows are picked on the host
from the active count, which the host tracks exactly
(:func:`repro_torch.core.split.next_population`).

:func:`integrate_device` is the port of the JAX package's device-resident
``lax.while_loop`` driver: it runs ``cfg.sync_every`` iterations per host
sync, on windows sized from an upper bound of the population (see its
docstring).

Both take a ``recorder`` (:mod:`repro_torch.telemetry`) with the JAX
package's names: ``core.eval`` / ``core.advance`` spans and a ``core.iter``
instant per iteration in :func:`integrate`, one ``core.device_loop`` span in
:func:`integrate_device`.  It records host numbers only and adds no read.
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
from repro_torch.core.integrands import get as get_integrand
from repro_torch.core.region_store import RegionState
from repro_torch.core.rules import make_rule
from repro_torch.core.split import classify_split_compact, next_population
from repro_torch.telemetry.core import NULL


@dataclasses.dataclass
class AdaptiveResult:
    integral: float
    error: float  # global error estimate (the paper's epsilon)
    status: str  # converged | max_iters | no_active | capacity | nonfinite
    iterations: int
    n_evals: float
    n_active: int
    overflowed: bool
    host_syncs: int = 0  # reads of device values by the host during the run
    # evaluate steps (integrate_device) or iterations (integrate_distributed)
    # enqueued, at least in part, after the stop, and discarded
    discarded: int = 0

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
    rule = make_rule(cfg, integrand)
    state = region_store.init_state(
        cfg.capacity, lo, hi, cfg.resolved_n_init(), dtype, device
    )
    return cfg, lo, hi, total_volume, rule, state


def integrate(
    cfg: QuadratureConfig,
    integrand=None,
    callback: Optional[Callable[[int, float, float, int], None]] = None,
    device="cuda",
    recorder=NULL,
) -> AdaptiveResult:
    """Host-driven adaptive integration, one host sync per iteration.

    ``integrand`` overrides ``cfg.integrand`` (a registry entry, or any
    torch callable ``f(x)``, which the GM rule evaluates on its torch route
    on ``device``).  ``callback(it, integral, error, n_active)`` is called
    once per evaluate step.

    ``recorder`` gets, per iteration, a ``core.eval`` span around the
    evaluate, the classify and the iteration's one read (so on the card it
    ends after the device has done that work), with the rule's ``route``
    among its attributes, a ``core.iter`` instant with the read values, and a ``core.advance`` span around the split and
    compact, which ends with no read: on the card it measures the host's
    enqueue time, not device time.
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
    syncs = 0
    for _ in range(cfg.max_iters):
        with recorder.span("core.eval", window=int(n_active), route=rule.route):
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
        syncs += 1
        integral, error, n_fin = synced[0], synced[1], int(synced[2])
        if recorder.enabled:
            recorder.event(
                "core.iter", it=it, integral=integral, error=error, n_active=int(n_active)
            )
        if callback is not None:
            callback(it, integral, error, n_active)
        if not (math.isfinite(integral) and math.isfinite(error)):
            # an integrand NaN/Inf reached the global reductions: quarantine
            # the offending regions and stop with the best-effort estimate
            # of the surviving population (terminal status "nonfinite")
            state, gi, ge, na = quarantine_step(state)
            gi, ge, na = torch.stack([gi.double(), ge.double(), na.double()]).tolist()
            syncs += 1
            integral, error, n_active = gi, ge, int(na)
            nonfinite = True
            break
        budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
        if error <= budget:
            converged = True
            break
        if n_active == 0:
            break
        with recorder.span("core.advance", n_active=int(n_active)):
            state = classify_split_compact(state, fin, window=ww)
            state.it += 1  # in place, on the device
        it += 1
        n_active = next_population(n_active - n_fin, C)

    n_evals, overflowed = torch.stack(
        [state.n_evals.double(), state.overflowed.double()]
    ).tolist()
    syncs += 1
    overflowed = bool(overflowed)
    return AdaptiveResult(
        integral=integral,
        error=error,
        status=result_status(converged, n_active, it, cfg, overflowed, nonfinite),
        iterations=it,
        n_evals=n_evals,
        n_active=n_active,
        overflowed=overflowed,
        host_syncs=syncs,
    )


# Fields of one iteration's snapshot in integrate_device, read by the host
# once per block of iterations.
_SNAP = ("integral", "error", "n_active", "n_evals", "it", "overflowed")


def record_event(device: torch.device):
    """An event behind the work queued so far on ``device`` (None on the
    CPU, where a copy has finished when it returns)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _landed(event) -> bool:
    """Whether the work behind ``event`` has finished, without waiting."""
    return event is None or event.query()


class LandedRows:
    """One row per iteration of a block, copied to pinned host memory
    without a sync, and what the host can learn from the rows that have
    landed without waiting.

    A driver that runs up to ``steps`` iterations per host read records a
    row per iteration: ``start()`` opens a block, ``record(row)`` queues the
    copy of the next row (into its first ``row.numel()`` entries) with an
    event behind it, ``landed()`` is the number of rows that have landed,
    found by querying the events in order, ``wait(n)`` blocks until n have,
    and ``rows`` the host copies (all of them after the read that ends the
    block).  With ``stop`` (a test of a host row), ``stopped()`` tells
    whether a landed row shows the stop, and ``stop_at`` is the first such
    row: from there on the driver enqueues nothing more.
    """

    def __init__(self, steps: int, width: int, device: torch.device,
                 dtype: torch.dtype = torch.int64, stop: Optional[Callable] = None):
        buf = torch.empty((steps, width), dtype=dtype, pin_memory=device.type == "cuda")
        self.rows = buf.numpy()
        self._slots = buf.unbind()
        self._device = device
        self._stop = stop
        self.start()

    def start(self) -> None:
        self._events = []  # one per row recorded in this block
        self._landed = 0  # rows known to have landed
        self.stop_at: Optional[int] = None

    def record(self, row: torch.Tensor) -> None:
        self._slots[len(self._events)][:row.numel()].copy_(row, non_blocking=True)
        self._events.append(record_event(self._device))

    def landed(self) -> int:
        while self._landed < len(self._events) and _landed(self._events[self._landed]):
            if self._stop is not None and self.stop_at is None and self._stop(self.rows[self._landed]):
                self.stop_at = self._landed
            self._landed += 1
        return self._landed

    def stopped(self) -> bool:
        self.landed()
        return self.stop_at is not None

    def wait(self, n: int) -> None:
        """Block until the first ``n`` recorded rows have landed: the host
        waits on the n-th row's event (no synchronising copy)."""
        event = self._events[n - 1]
        if event is not None:
            event.synchronize()
        self.landed()


def stops(cfg: QuadratureConfig, integral: float, error: float, n_active) -> bool:
    """The fused loops' stop: the error within the budget, or no active region."""
    return error <= max(cfg.abs_tol, abs(integral) * cfg.rel_tol) or not n_active


def integrate_device(
    cfg: QuadratureConfig, integrand=None, device="cuda", recorder=NULL
) -> AdaptiveResult:
    """Device-resident driver: ``cfg.sync_every`` iterations per host sync.

    The JAX package runs the whole loop as one ``lax.while_loop`` on the
    device.  PyTorch has no such loop, and the active windows are host
    integers, so this driver runs blocks of K = ``cfg.sync_every``
    iterations without reading anything back:

    - after each advance the population is copied to pinned host memory
      without waiting (with a CUDA event behind it).  Iteration j sizes its
      eval window for ``min(n * 2^(j - i), C)`` regions, where n is the
      newest population whose copy has landed (that of iteration i, found
      by querying the events) and its advance window for twice that: an
      upper bound of the population, since a split at most doubles it.
      Any window that covers the population gives the same bits
      (``region_store.tree_sum``), so the result equals :func:`integrate`'s
      exactly, whether a copy landed in time or not; when the host runs
      ahead of the device, the windows grow up to 2^(K-1) times the rows;
    - every iteration records on the device a snapshot of (integral, error,
      active count, ``n_evals``, ``it``, ``overflowed``) after its evaluate
      step, and copies it to pinned host memory the same way;
    - before each evaluate and each advance the host queries the snapshots'
      events: once a landed snapshot shows the stop (converged, or no
      active region), it enqueues nothing more, as the JAX loop stops on
      the device;
    - the host reads the block's snapshots with one sync and takes the
      first iteration that converged (or found no active region).  The
      evaluate steps enqueued after it, before its snapshot landed, are
      discarded (``discarded``): the result is read from the snapshot, not
      from the state, which is never read again.

    As in the JAX package's loop, a run cut by ``cfg.max_iters`` reports
    the estimates of the state after its last advance (its new children
    still unevaluated), and there is no quarantine: ``nonfinite`` comes
    from the final values.  ``iterations`` is the state's ``it``.  The
    host syncs are at most ceil((iterations + 1) / K).

    ``recorder`` gets one ``core.device_loop`` span around the whole loop,
    as in the JAX package, whose host cannot see the loop's iterations.
    """
    device = resolve_device(device)
    cfg, lo, hi, total_volume, rule, state = _setup(cfg, integrand, device)
    width = torch.as_tensor(hi - lo, device=device)
    ladder = eval_ladder(cfg)
    adv_ladder = advance_ladder(cfg)
    C = cfg.capacity

    def snapshot(state, integral, error, active):
        return torch.stack([x.double() for x in (
            integral, error, active.sum(), state.n_evals, state.it, state.overflowed)])

    # the population after each advance of a block, and each iteration's
    # snapshot, copied without a sync
    counts = LandedRows(cfg.sync_every, 1, device)
    snaps = LandedRows(cfg.sync_every, len(_SNAP), device, torch.float64,
                       stop=lambda row: stops(cfg, row[0], row[1], row[2]))
    n = cfg.resolved_n_init()  # exact population at the start of a block
    it = 0
    syncs = 0
    discarded = 0
    final = None
    with recorder.span("core.device_loop", max_iters=cfg.max_iters):
        while final is None:
            steps = min(cfg.sync_every, cfg.max_iters - it)
            block = []
            counts.start()
            snaps.start()
            for j in range(steps):
                if snaps.stopped():
                    break
                m = counts.landed()
                bound = min((int(counts.rows[m - 1, 0]) if m else n) << (j - m), C)
                state = make_eval_step(cfg, rule, window=region_store.select_window(ladder, bound))(state)
                w = region_store.select_window(adv_ladder, advance_target(bound, C))
                ww = None if w == C else w
                integral, error, fin = classify_window(cfg, state, total_volume, width, ww)
                block.append(snapshot(state, integral, error, state.active[:w]))
                snaps.record(block[-1])
                if snaps.stopped():
                    break
                state = classify_split_compact(state, fin, window=ww)
                state.it += 1  # in place, on the device
                counts.record(state.active[:w].sum())
            else:
                if it + steps == cfg.max_iters:
                    # the loop ends after this advance: its estimates are the result
                    block.append(snapshot(state, *state.global_estimates(), state.active))
            rows = [dict(zip(_SNAP, r)) for r in torch.stack(block).tolist()]
            syncs += 1
            stop = next((j for j, row in enumerate(rows[:steps])
                         if stops(cfg, row["integral"], row["error"], row["n_active"])), None)
            if stop is not None:
                final = rows[stop]
                discarded = min(len(rows), steps) - stop - 1
            elif it + steps == cfg.max_iters:
                final = rows[-1]
            else:
                n = int(counts.rows[steps - 1, 0])  # landed: the read above synced
                it += steps

    integral, error = final["integral"], final["error"]
    n_active, iterations = int(final["n_active"]), int(final["it"])
    overflowed = bool(final["overflowed"])
    nonfinite = not (math.isfinite(integral) and math.isfinite(error))
    budget = max(cfg.abs_tol, abs(integral) * cfg.rel_tol)
    return AdaptiveResult(
        integral=integral,
        error=error,
        status=result_status(
            error <= budget, n_active, iterations, cfg, overflowed, nonfinite
        ),
        iterations=iterations,
        n_evals=final["n_evals"],
        n_active=n_active,
        overflowed=overflowed,
        host_syncs=syncs,
        discarded=discarded,
    )


def integrate_exact_check(cfg: QuadratureConfig, device="cuda") -> tuple[AdaptiveResult, float]:
    """Integrate a registry integrand (or a family spec) with :func:`integrate`
    and return the result with its true relative error against the analytic
    exact value."""
    spec = get_integrand(cfg.integrand)
    res = integrate(cfg, device=device)
    exact = spec.exact(cfg.d)
    rel = abs(res.integral - exact) / max(abs(exact), 1e-300)
    return res, rel
