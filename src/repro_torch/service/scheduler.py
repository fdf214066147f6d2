"""Continuous-batching scheduler for the batch quadrature engine.

The port of the JAX package's ``repro.service.scheduler``: the host loop
that turns the fixed-shape :class:`~repro_torch.service.batch_engine.BatchEngine`
into a service.  A FIFO request stream feeds ``cfg.batch_slots`` slots;
every ``cfg.admit_every`` iterations freed slots are refilled from the
stream (mid-flight: the other slots keep refining), and finished slots are
collected and yielded as :class:`QuadResult`\\ s as soon as their ``done``
flag flips, in convergence order rather than submission order.

The engine is driven through :meth:`~BatchEngine.run`: up to
``cfg.sync_every`` iterations per call, ending early the moment any slot
finishes, so the host observes every collection at its exact iteration.
The scheduler also caps a call so that it cannot run past the next
``admit_every`` tick while an admission is pending.  Results (including
``admitted_at`` / ``finished_at``) are therefore the same at any
``sync_every`` and any rank count.

Over several ranks, admissions fill the free slots of the least-loaded rank
first, and the migration records of the engine's cyclic rebalancer are
replayed onto the host's slot -> request map in iteration order.

Termination statuses (as ``AdaptiveResult.status``): ``converged``,
``capacity`` (the store saturated and the slot stayed unconverged for
``cfg.evict_patience`` more iterations: it is evicted with its best-effort
estimate), ``no_active``, ``max_iters``, ``nonfinite`` (NaN/Inf estimates,
quarantined in the engine) and ``deadline`` (the request's ``deadline_s``
or ``max_evals`` expired at a dispatch boundary).

The scheduler fronts two engine pools behind one slot protocol: the
cubature :class:`BatchEngine` and the Monte Carlo
:class:`~repro_torch.mc.engine.VegasBatchEngine` (``backend="auto"`` picks
by dimension).  Fallback re-routing of degraded requests lives in
:mod:`repro_torch.service.routing`.

Not ported yet (ROADMAP queue 1 item 7b): service checkpoints and resume,
fault injection, the dispatch watchdog and the elastic mesh; their
arguments raise :class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand
from repro_torch.mc.engine import VegasBatchEngine
from repro_torch.service.batch_engine import BatchEngine, BatchState
from repro_torch.service.stats import ServiceStats

RESILIENCE = (
    "service checkpoints and resume, fault injection and the dispatch "
    "watchdog are not ported yet (ROADMAP queue 1 item 7b)"
)


def make_engine(
    cfg: QuadratureConfig,
    family: Union[ParamIntegrand, str, None] = None,
    devices: Optional[Sequence] = None,
) -> Union[BatchEngine, VegasBatchEngine]:
    """Engine for ``cfg``'s resolved backend: the cubature
    :class:`BatchEngine`, or the single-rank VEGAS pool (``backend="auto"``
    resolves by dimension, so high-d fleets are served by MC instead of
    exploding the region stores)."""
    if cfg.resolved_backend() == "vegas":
        return VegasBatchEngine(cfg, family, devices=devices)
    return BatchEngine(cfg, family, devices=devices)


@dataclasses.dataclass(frozen=True)
class QuadRequest:
    """One integration problem: a theta of the engine's family + tolerances.

    ``deadline_s`` / ``max_evals`` are best-effort SLOs, checked at dispatch
    boundaries: once either is exhausted the slot is evicted with its
    current partial estimate and status ``deadline``.  ``max_evals`` is
    deterministic (integrand evaluations); ``deadline_s`` is wall clock
    from admission.
    """

    req_id: int
    theta: Any  # dict matching the family's theta_fields, leaves (d,)
    rel_tol: Optional[float] = None  # None -> cfg default
    abs_tol: Optional[float] = None
    deadline_s: Optional[float] = None  # wall-clock budget from admission
    max_evals: Optional[float] = None  # integrand-evaluation budget


@dataclasses.dataclass(frozen=True)
class QuadResult:
    """Terminal state of one request (statuses as in AdaptiveResult).

    ``backend`` / ``attempts`` / ``retried_from`` record attempt provenance:
    the engine pool that produced this estimate, the admissions the request
    consumed in total, and, for a re-routed or retried request, the
    terminal status of the attempt that triggered the retry (see
    :class:`repro_torch.service.routing.GracefulScheduler`).  The JAX
    package's evacuation provenance (``evacuated``) comes with the elastic
    mesh (ROADMAP queue 1 item 7b).
    """

    req_id: int
    integral: float
    error: float
    status: str  # converged | capacity | no_active | max_iters | nonfinite | deadline
    iterations: int  # per-slot adaptive iterations spent on this problem
    n_evals: float  # integrand evaluations spent on this problem
    admitted_at: int  # scheduler iteration at which the slot was filled
    finished_at: int  # scheduler iteration at which done flipped on
    backend: str = "cubature"  # engine pool that produced this estimate
    attempts: int = 1  # admissions consumed (1 = first attempt)
    retried_from: Optional[str] = None  # prior attempt's terminal status

    def summary(self) -> str:
        via = f" via={self.backend}" if self.attempts > 1 else ""
        return (
            f"req={self.req_id} I={self.integral:.15e} eps={self.error:.3e} "
            f"[{self.status}] iters={self.iterations} evals={self.n_evals:.3g}{via}"
        )


def encode_request(req: QuadRequest) -> dict:
    """JSON-able form of a request (theta leaves as float64 lists).

    ``json`` writes a float64 through ``repr``, which round-trips exactly,
    so decoding an encoding gives the identical problem.
    """
    return {
        "req_id": int(req.req_id),
        "theta": {k: np.asarray(v, np.float64).tolist() for k, v in req.theta.items()},
        "rel_tol": None if req.rel_tol is None else float(req.rel_tol),
        "abs_tol": None if req.abs_tol is None else float(req.abs_tol),
        "deadline_s": None if req.deadline_s is None else float(req.deadline_s),
        "max_evals": None if req.max_evals is None else float(req.max_evals),
    }


def decode_request(obj: dict, theta_template) -> QuadRequest:
    """Inverse of :func:`encode_request`; ``theta_template`` (the engine's)
    gives each theta leaf its shape."""
    theta = {
        k: np.asarray(obj["theta"][k], np.float64).reshape(np.shape(t))
        for k, t in theta_template.items()
    }
    return QuadRequest(
        req_id=int(obj["req_id"]),
        theta=theta,
        rel_tol=obj.get("rel_tol"),
        abs_tol=obj.get("abs_tol"),
        deadline_s=obj.get("deadline_s"),
        max_evals=obj.get("max_evals"),
    )


class BatchScheduler:
    """Drives a :class:`BatchEngine` (or a VEGAS pool) over an arbitrary
    stream of requests.

    After :meth:`serve` completes, :attr:`last_stats` is a dict view of the
    run's :class:`~repro_torch.service.stats.ServiceStats`: ``iterations``
    (fleet iterations), ``dispatches`` (engine ``run`` calls),
    ``admissions``, ``collections``, ``migrations`` (problems moved between
    ranks), ``quarantines`` (slots collected ``nonfinite``) and
    ``deadlines`` (slots evicted on an expired SLO).

    ``on_tick(it, state, slot_req)`` is a host hook called at every dispatch
    boundary; it may return a replacement state or ``None``.
    """

    def __init__(
        self,
        cfg: QuadratureConfig,
        family: Union[ParamIntegrand, str, None] = None,
        engine: Union[BatchEngine, VegasBatchEngine, None] = None,
        devices: Optional[Sequence] = None,
        checkpointer=None,
        checkpoint_every: int = 0,
        on_tick: Optional[Callable] = None,
        fault_injector=None,
        dispatch_timeout_s: Optional[float] = None,
    ):
        if (
            checkpointer is not None
            or checkpoint_every
            or fault_injector is not None
            or dispatch_timeout_s is not None
        ):
            raise NotImplementedError(RESILIENCE)
        if engine is not None:
            if devices is not None:
                raise ValueError(
                    "pass devices to the BatchEngine, not alongside an explicit "
                    "engine: the engine's ranks are fixed at construction"
                )
            self.engine = engine
        else:
            self.engine = make_engine(cfg, family, devices=devices)
        self.cfg = self.engine.cfg
        self.on_tick = on_tick
        self._stats = ServiceStats()

    @property
    def last_stats(self) -> dict:
        """Dict view of the latest run's :class:`ServiceStats`."""
        return self._stats.as_dict()

    def serve(
        self, requests: Iterable[QuadRequest], resume: bool = False
    ) -> Iterator[QuadResult]:
        """Run the fleet to completion, yielding results as slots converge.

        ``requests`` may be any iterable, a generator included: it is pulled
        from only when a slot is free, so an unbounded stream backpressures.
        Every request yields exactly one result.
        """
        if resume:
            raise NotImplementedError(RESILIENCE)
        engine = self.engine
        cfg = self.cfg
        B = engine.n_slots
        S = engine.slots_per_rank
        pending = iter(requests)
        exhausted = False  # the iterator signalled StopIteration
        slot_req: list[Optional[QuadRequest]] = [None] * B
        slot_admitted = np.zeros(B, np.int64)
        slot_wall = [0.0] * B  # admission wall clock, for deadline_s
        stats = ServiceStats()
        self._stats = stats

        state = engine.init()
        it = 0

        def pull() -> Optional[QuadRequest]:
            # Requests are pulled only from admission passes, never
            # speculatively, so a generator that derives its next request
            # from the results so far sees the per-iteration loop's pull
            # points.
            nonlocal exhausted
            if exhausted:
                return None
            req = next(pending, None)
            if req is None:
                exhausted = True
            return req

        def admission_order() -> list[int]:
            """Free slots, least-loaded rank first (plain slot order on one
            rank)."""
            free = [s for s in range(B) if slot_req[s] is None]
            if engine.n_ranks == 1:
                return free
            load = [0] * engine.n_ranks
            for s in range(B):
                if slot_req[s] is not None:
                    load[s // S] += 1
            # admitting onto a rank raises its load for the next pick, so a
            # burst of admissions round-robins across the drained ranks
            order: list[int] = []
            free_per_rank = [[s for s in free if s // S == r] for r in range(engine.n_ranks)]
            for _ in free:
                rank = min(
                    (r for r in range(engine.n_ranks) if free_per_rank[r]),
                    key=lambda r: (load[r], r),
                )
                order.append(free_per_rank[rank].pop(0))
                load[rank] += 1
            return order

        def admit_free_slots(state: BatchState) -> BatchState:
            for slot in admission_order():
                req = pull()
                if req is None:
                    break
                state = engine.admit(state, slot, req.theta, req.rel_tol, req.abs_tol)
                slot_req[slot] = req
                slot_admitted[slot] = it
                slot_wall[slot] = time.monotonic()
                stats.add("admissions")
            return state

        def apply_moves(rows: np.ndarray) -> None:
            """Replay one iteration's migrations onto the host map.  Within a
            round the sources (live slots) and destinations (free slots) are
            disjoint, so copy-then-clear is exact."""
            valid = [(int(s), int(d)) for s, d in rows if s >= 0]
            if not valid:
                return
            snapshot_req = list(slot_req)
            snapshot_adm = slot_admitted.copy()
            snapshot_wall = list(slot_wall)
            for src, dst in valid:
                assert snapshot_req[src] is not None, (src, dst)
                slot_req[dst] = snapshot_req[src]
                slot_admitted[dst] = snapshot_adm[src]
                slot_wall[dst] = snapshot_wall[src]
                slot_req[src] = None
            stats.add("migrations", len(valid))

        def result(req, slot, ms, k, status) -> QuadResult:
            return QuadResult(
                req_id=req.req_id,
                integral=float(ms["integral"][k - 1][slot]),
                error=float(ms["error"][k - 1][slot]),
                status=status,
                iterations=int(ms["it"][k - 1][slot]),
                n_evals=float(ms["n_evals"][k - 1][slot]),
                admitted_at=int(slot_admitted[slot]),
                finished_at=it,
                backend=engine.backend,
            )

        state = admit_free_slots(state)
        while any(r is not None for r in slot_req):
            # A dispatch may not run past the next admit tick while an
            # admission may be pending (a free slot and a stream not yet known
            # to be exhausted): the tick is a host decision.  Once the stream
            # is exhausted, full-length dispatches resume for the drain.
            max_steps = cfg.sync_every
            if not exhausted and any(r is None for r in slot_req):
                max_steps = min(max_steps, cfg.admit_every - it % cfg.admit_every)
            state, ms, executed, moved = engine.run(state, max_steps, it)
            k = int(np.sum(executed))
            assert k >= 1, "dispatch executed no iterations"
            stats.add("dispatches")
            stats.add("iterations", k)
            for t in range(k - 1):
                it += 1
                apply_moves(moved[t])
            it += 1
            done = ms["done"][k - 1]
            occupied = ms["occupied"][k - 1]
            finished = [
                (slot_req[s].req_id, s)
                for s in range(B)
                if done[s] and occupied[s] and slot_req[s] is not None
            ]
            # req_id order: the same at every rank count (collection within
            # one iteration has no inherent slot order)
            collected: list[QuadResult] = []
            for req_id, slot in sorted(finished):
                status = engine.status_of(
                    bool(ms["converged"][k - 1][slot]),
                    int(ms["n_active"][k - 1][slot]),
                    int(ms["it"][k - 1][slot]),
                    bool(ms["overflowed"][k - 1][slot]),
                    bool(ms["nonfinite"][k - 1][slot]),
                )
                stats.add("collections")
                if status == "nonfinite":
                    stats.add("quarantines")
                collected.append(result(slot_req[slot], slot, ms, k, status))
            yield from collected
            # migrations of the final iteration happened after its metrics
            # (and done slots never migrate), so the map update follows
            # collection
            apply_moves(moved[k - 1])
            for _, slot in finished:
                state = engine.release(state, slot)
                slot_req[slot] = None
            # Deadline sweep, at the dispatch boundary (the host cannot
            # observe a slot mid-dispatch): the slot's last metrics are its
            # best-effort partial estimate.
            now = time.monotonic()
            for slot in range(B):
                req = slot_req[slot]
                if req is None or (req.deadline_s is None and req.max_evals is None):
                    continue
                over_wall = req.deadline_s is not None and now - slot_wall[slot] > req.deadline_s
                over_evals = (
                    req.max_evals is not None
                    and float(ms["n_evals"][k - 1][slot]) > req.max_evals
                )
                if not (over_wall or over_evals):
                    continue
                stats.add("deadlines")
                yield result(req, slot, ms, k, "deadline")
                state = engine.release(state, slot)
                slot_req[slot] = None
            # Admit on the configured cadence, but never leave the fleet idle
            # with work still queued.
            if it % cfg.admit_every == 0 or all(r is None for r in slot_req):
                state = admit_free_slots(state)
            if self.on_tick is not None:
                replacement = self.on_tick(it, state, list(slot_req))
                if replacement is not None:
                    state = replacement
        # drain: nothing in flight, so nothing may remain unadmitted
        leftover = pull()
        if leftover is not None:  # pragma: no cover - invariant guard
            raise RuntimeError(
                f"scheduler exited with queued requests (req_id={leftover.req_id})"
            )
