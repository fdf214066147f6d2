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
:mod:`repro_torch.service.routing`, service checkpoints in
:mod:`repro_torch.service.checkpoint`.

The scheduler is elastic in its rank set: every dispatch runs under a host
watchdog (:class:`DispatchTimeout` / :class:`DeviceLostError`, bounded
retries with exponential backoff), and a rank declared lost is evacuated
(slots that a snapshot covers rewind to it, the others' requests go back
to the admission queue with provenance) before the engine is rebuilt on the
largest set of surviving ranks, and regrown once the rank heals.  A rank is
the JAX package's mesh device: one host process drives every rank
(:mod:`repro_torch.core.ranks`), and a lost rank is one that the fault
injector marks down.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand
from repro_torch.mc.engine import VegasBatchEngine
from repro_torch.service.batch_engine import BatchEngine, BatchState
from repro_torch.service.stats import ServiceStats



class DeviceLostError(RuntimeError):
    """A rank failed for good (retries exhausted, or nowhere to evacuate).

    ``device`` is the rank's index among the engine's *original* ranks, or
    ``None`` when the watchdog could not attribute the fault to a rank.
    Raised by injectors (:class:`repro_torch.service.faults.DeviceDown`) to
    simulate the loss, and by the scheduler only when recovery is
    impossible: a one-rank engine has nowhere to evacuate to.
    """

    def __init__(self, device: Optional[int], message: str):
        super().__init__(message)
        self.device = device


class DispatchTimeout(RuntimeError):
    """A dispatch outlasted the watchdog's ``dispatch_timeout_s``.

    It names no rank (a hang looks the same from the host whichever rank
    wedged), so the scheduler asks the injector's ``healthy`` probe, or
    gives up, to pick the rank to declare lost.
    """


class _Attempt:
    """One dispatch attempt's claim on the live fleet state.

    The port's engines update the state in place, so an attempt that the
    watchdog gave up on must never touch it: its thread could wake in the
    middle of the retried dispatch.  The worker claims the state before it
    touches it; the watchdog revokes the attempt at its timeout.  Whichever
    comes first wins, under one lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._state = "pending"

    def claim(self) -> bool:
        with self._lock:
            if self._state == "revoked":
                return False
            self._state = "claimed"
            return True

    def revoke(self) -> bool:
        with self._lock:
            if self._state == "claimed":
                return False
            self._state = "revoked"
            return True


def _call_with_timeout(fn: Callable[[_Attempt], Any], timeout_s: Optional[float]):
    """Run ``fn(attempt)`` under a wall-clock watchdog.

    With a timeout the call runs on a daemon thread and a ``join`` bounds
    the wait: a wedged attempt is revoked and raises :class:`DispatchTimeout`
    on the host, and its thread is abandoned (it returns without touching
    the state when it wakes).  An attempt that already claimed the state
    when the timeout struck cannot be abandoned or retried, since it is
    changing the live state: that raises a plain ``RuntimeError``.
    Exceptions of ``fn`` itself propagate unchanged.
    """
    attempt = _Attempt()
    if timeout_s is None:
        return fn(attempt)
    box: dict = {}

    def target():
        try:
            box["value"] = fn(attempt)
        except BaseException as err:  # noqa: BLE001 - re-raised on the host
            box["error"] = err

    worker = threading.Thread(target=target, daemon=True, name="dispatch-watchdog")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        if attempt.revoke():
            raise DispatchTimeout(f"dispatch still running after {timeout_s}s watchdog")
        raise RuntimeError(
            f"dispatch still running after {timeout_s}s watchdog, with the engine "
            "already updating the fleet state in place: it can be neither "
            "abandoned nor retried"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


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
    :class:`repro_torch.service.routing.GracefulScheduler`).  ``evacuated``
    records rank-loss provenance: ``"snapshot"`` when the request's slot was
    recovered from the newest service snapshot after its rank was lost (its
    trajectory rewound and replayed, the same bits), ``"readmit"`` when no
    snapshot covered it and the request was admitted again from scratch
    (``attempts`` grows and ``retried_from`` is ``"device_lost"``), ``None``
    when no rank loss touched it.
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
    evacuated: Optional[str] = None  # rank-loss recovery: snapshot | readmit

    def summary(self) -> str:
        via = f" via={self.backend}" if self.attempts > 1 else ""
        evac = f" evac={self.evacuated}" if self.evacuated else ""
        return (
            f"req={self.req_id} I={self.integral:.15e} eps={self.error:.3e} "
            f"[{self.status}] iters={self.iterations} evals={self.n_evals:.3g}{via}{evac}"
        )


def encode_request(req: QuadRequest) -> dict:
    """JSON-able form of a request (theta leaves as float64 lists).

    ``json`` writes a float64 through ``repr``, which round-trips exactly,
    so decoding an encoding gives the identical problem: the resume parity
    of service checkpoints rests on it.
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
    ranks), ``quarantines`` (slots collected ``nonfinite``), ``deadlines``
    (slots evicted on an expired SLO), ``checkpoints``, and the rank-set
    counters ``dispatch_retries``, ``evacuations``, ``mesh_shrinks`` and
    ``mesh_regrows``.

    ``checkpointer`` (a :class:`~repro_torch.service.checkpoint.ServiceCheckpointer`)
    snapshots the engine state and the slot -> request map every
    ``checkpoint_every`` admission ticks; ``serve(resume=True)`` restores
    the newest snapshot and replays from it, with the same bits for every
    slot the crash did not touch.  ``on_tick(it, state, slot_req)`` is a
    host hook called at every dispatch boundary (fault injection,
    monitoring); it may return a replacement state or ``None``.

    **Rank loss.**  Every dispatch runs under a host watchdog.  A
    :class:`DeviceLostError` from ``fault_injector``'s pre-dispatch hook
    (see :class:`repro_torch.service.faults.DeviceDown`), or a
    :class:`DispatchTimeout` past ``dispatch_timeout_s``, is retried up to
    ``max_dispatch_retries`` times with exponential backoff
    (``retry_backoff_s * 2**attempt``): a transient fault leaves the run
    bit-identical to a fault-free one.  When the retries run out the rank
    is declared lost: its slots are evacuated (from the newest snapshot
    where it covers them, else their requests are admitted again with
    ``attempts`` / ``retried_from`` / ``evacuated`` provenance), the engine
    is rebuilt on the largest set of surviving ranks whose size divides
    ``batch_slots``, and the fleet serves on.  A later admission tick
    regrows the rank set once the injector reports the rank healthy.  All
    of it happens between dispatches.
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
        max_dispatch_retries: int = 2,
        dispatch_timeout_s: Optional[float] = None,
        retry_backoff_s: float = 0.1,
    ):
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
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {checkpoint_every}")
        if checkpoint_every and checkpointer is None:
            raise ValueError("checkpoint_every > 0 requires a checkpointer")
        if max_dispatch_retries < 0:
            raise ValueError(f"max_dispatch_retries must be >= 0, got {max_dispatch_retries}")
        if dispatch_timeout_s is not None and dispatch_timeout_s <= 0:
            raise ValueError(f"dispatch_timeout_s must be positive, got {dispatch_timeout_s}")
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.on_tick = on_tick
        self.fault_injector = fault_injector
        self.max_dispatch_retries = max_dispatch_retries
        self.dispatch_timeout_s = dispatch_timeout_s
        self.retry_backoff_s = retry_backoff_s
        self._stats = ServiceStats()
        # The rank set.  Ranks are named by their index among the engine's
        # ORIGINAL ranks for the scheduler's lifetime: the injector's rank
        # ids and the regrow target speak this namespace.  The VEGAS pool
        # (one rank) is not elastic: _all_devices stays None and a lost
        # rank is fatal.
        ranks = getattr(self.engine, "ranks", None)
        self._all_devices = list(ranks.devices) if ranks is not None else None
        self._current_devs = list(range(self.engine.n_ranks))
        self._failed: set = set()

    @property
    def last_stats(self) -> dict:
        """Dict view of the latest run's :class:`ServiceStats`."""
        return self._stats.as_dict()

    # --- the elastic rank set --------------------------------------------------

    def _healthy_mesh(self) -> list:
        """The largest set of healthy ranks whose size divides the slot
        count, as original rank indices in order.

        ``batch_slots % n_ranks == 0`` is the engine's block placement, so
        losing one rank of 4 with 8 slots shrinks to 2, idling a healthy
        rank until a regrow.
        """
        healthy = [r for r in range(len(self._all_devices)) if r not in self._failed]
        if not healthy:
            raise DeviceLostError(None, "every device in the mesh has failed")
        B = self.engine.n_slots
        m = max(k for k in range(1, len(healthy) + 1) if B % k == 0)
        return healthy[:m]

    def _rebuild_engine(self, dev_indices: list):
        """A new engine on the given original ranks' devices (its migration
        schedule follows the new rank count)."""
        devices = [self._all_devices[i] for i in dev_indices]
        self.engine = make_engine(self.cfg, self.engine.family, devices=devices)
        self._current_devs = list(dev_indices)
        return self.engine

    def _attribute_fault(self, err: Exception, it: int) -> Optional[int]:
        """The original rank a dispatch fault is blamed on: the error's own,
        else the first current rank that the injector's ``healthy`` probe
        reports down."""
        dev = getattr(err, "device", None)
        if dev is not None:
            return int(dev)
        probe = getattr(self.fault_injector, "healthy", None)
        if probe is not None:
            for r in self._current_devs:
                if not probe(r, it):
                    return r
        return None

    def serve(
        self, requests: Iterable[QuadRequest], resume: bool = False
    ) -> Iterator[QuadResult]:
        """Run the fleet to completion, yielding results as slots converge.

        ``requests`` may be any iterable, a generator included: it is pulled
        from only when a slot is free, so an unbounded stream backpressures.
        Every request yields exactly one result.

        With ``resume=True`` the newest service snapshot is restored first:
        in-flight slots resume mid-refinement, requests the crashed run had
        already pulled are skipped from ``requests`` (the caller supplies
        the same stream again), and requests that finished after the
        snapshot are served again, with the same bits as the crashed run
        yielded.
        """
        engine = self.engine
        cfg = self.cfg
        B = engine.n_slots
        pending = iter(requests)
        exhausted = False  # the iterator signalled StopIteration
        slot_req: list[Optional[QuadRequest]] = [None] * B
        slot_admitted = np.zeros(B, np.int64)
        slot_wall = [0.0] * B  # admission wall clock, for deadline_s
        pulled_ids: set[int] = set()
        skip_ids: set[int] = set()
        # Requests bumped off a lost rank wait in retry_queue (served before
        # the stream, in order), and the evac_* maps carry their provenance
        # into their QuadResult.
        retry_queue: deque = deque()
        evac_attempts: dict = {}  # req_id -> extra admissions consumed
        evac_from: dict = {}  # req_id -> status that triggered the retry
        evac_kind: dict = {}  # req_id -> "snapshot" | "readmit"
        stats = ServiceStats()
        self._stats = stats
        it = 0
        ticks = 0  # admission passes completed (the checkpoint cadence's unit)

        if resume:
            if self.checkpointer is None:
                raise ValueError("resume=True requires a checkpointer")
            state, meta = self.checkpointer.restore(engine)
            it = int(meta["it"])
            ticks = int(meta["ticks"])
            stats.merge(ServiceStats.from_dict(meta["stats"]))
            pulled_ids = set(meta["pulled_ids"])
            skip_ids = set(pulled_ids)
            for entry in meta["slots"]:
                slot = int(entry["slot"])
                slot_req[slot] = decode_request(entry["req"], engine.theta_template)
                slot_admitted[slot] = int(entry["admitted_at"])
                slot_wall[slot] = time.monotonic()  # wall deadlines restart
        else:
            state = engine.init()

        def pull() -> Optional[QuadRequest]:
            # Requests are pulled only from admission passes, never
            # speculatively, so a generator that derives its next request
            # from the results so far sees the per-iteration loop's pull
            # points.  On resume the requests the crashed run had pulled are
            # skipped; evacuated requests come first.
            nonlocal exhausted
            if retry_queue:
                return retry_queue.popleft()
            if exhausted:
                return None
            req = next(pending, None)
            while req is not None and req.req_id in skip_ids:
                req = next(pending, None)
            if req is None:
                exhausted = True
            else:
                pulled_ids.add(req.req_id)
            return req

        def admission_order() -> list[int]:
            """Free slots, least-loaded rank first (plain slot order on one
            rank)."""
            free = [s for s in range(B) if slot_req[s] is None]
            n, S = engine.n_ranks, engine.slots_per_rank
            if n == 1:
                return free
            load = [0] * n
            for s in range(B):
                if slot_req[s] is not None:
                    load[s // S] += 1
            # admitting onto a rank raises its load for the next pick, so a
            # burst of admissions round-robins across the drained ranks
            order: list[int] = []
            free_per_rank = [[s for s in free if s // S == r] for r in range(n)]
            for _ in free:
                rank = min((r for r in range(n) if free_per_rank[r]), key=lambda r: (load[r], r))
                order.append(free_per_rank[rank].pop(0))
                load[rank] += 1
            return order

        def admit_free_slots(state):
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

        def admission_tick(state):
            """One admission pass, with the regrow before it and the
            checkpoint cadence after it.

            The snapshot follows the admissions, so a resumed run goes on
            from a tick boundary: its next host decision is the next
            dispatch, as in the original run.  A lost rank that the
            injector reports healthy again rejoins before the admissions,
            so they spread over the regrown rank set.
            """
            nonlocal engine, ticks
            probe = getattr(self.fault_injector, "healthy", None)
            if self._failed and probe is not None:
                restored = [r for r in sorted(self._failed) if probe(r, it)]
                if restored:
                    self._failed.difference_update(restored)
                    target = self._healthy_mesh()
                    if len(target) > engine.n_ranks:
                        host = engine.to_host(state)
                        engine = self._rebuild_engine(target)
                        state = engine.place(host)
                        stats.add("mesh_regrows")
            state = admit_free_slots(state)
            ticks += 1
            if (
                self.checkpointer is not None
                and self.checkpoint_every > 0
                and ticks % self.checkpoint_every == 0
            ):
                meta = {
                    "it": it,
                    "ticks": ticks,
                    "stats": stats.as_dict(),
                    "pulled_ids": sorted(pulled_ids),
                    "slots": [
                        {"slot": s, "req": encode_request(slot_req[s]),
                         "admitted_at": int(slot_admitted[s])}
                        for s in range(B)
                        if slot_req[s] is not None
                    ],
                }
                self.checkpointer.save(it, engine.to_host(state), meta)
                stats.add("checkpoints")
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

        def evacuate_and_shrink(state, dev: int):
            """Recover the lost rank's slots and rebuild on the survivors.

            Slots that the newest readable snapshot covers rewind to it row
            for row (their replay is deterministic, so the final values keep
            their bits); the others lose their progress, and their requests
            go back to the queue with ``attempts`` / ``retried_from`` /
            ``evacuated`` provenance.  The surviving ranks' slots carry over
            untouched: a slot's trajectory does not depend on its rank.
            """
            nonlocal engine
            if self._all_devices is None or engine.n_ranks <= 1:
                raise DeviceLostError(
                    dev, f"device {dev} lost permanently with no surviving sub-mesh to evacuate to"
                )
            S = engine.slots_per_rank
            local = self._current_devs.index(dev)
            self._failed.add(dev)
            target = self._healthy_mesh()
            # The fault fired at the dispatch boundary, before the engine
            # touched the state, so it is intact.  A real loss would lose
            # the lost rank's rows: exactly the rows rewound or released
            # below.
            host = engine.to_host(state)
            snap = snap_meta = None
            if self.checkpointer is not None:
                try:
                    snap, snap_meta, _ = self.checkpointer.restore_host(host)
                except FileNotFoundError:
                    pass
            snap_slots = {}
            if snap_meta is not None:
                snap_slots = {int(e["slot"]): int(e["req"]["req_id"]) for e in snap_meta["slots"]}
            for s in range(local * S, (local + 1) * S):
                req = slot_req[s]
                if req is None:
                    continue
                if snap is not None and snap_slots.get(s) == req.req_id:
                    # rewind the slot to the snapshot row for row (masks
                    # included); the replay derives the lost refinement again
                    for k, v in host.items():
                        v[s] = snap[k][s]
                    evac_kind[req.req_id] = "snapshot"
                    slot_wall[s] = time.monotonic()  # the wall SLO restarts
                else:
                    host["occupied"][s] = False
                    host["done"][s] = False
                    retry_queue.append(req)
                    evac_attempts[req.req_id] = evac_attempts.get(req.req_id, 0) + 1
                    evac_from[req.req_id] = "device_lost"
                    evac_kind[req.req_id] = "readmit"
                    slot_req[s] = None
                stats.add("evacuations")
            engine = self._rebuild_engine(target)
            state = engine.place(host)
            stats.add("mesh_shrinks")
            return state

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
                attempts=1 + evac_attempts.pop(req.req_id, 0),
                retried_from=evac_from.pop(req.req_id, None),
                evacuated=evac_kind.pop(req.req_id, None),
            )

        if not resume:
            # on resume the snapshot was taken at a tick boundary, right
            # after its admissions: the next host decision is the dispatch
            state = admission_tick(state)
        while any(r is not None for r in slot_req) or retry_queue:
            if not any(r is not None for r in slot_req):
                # an evacuation emptied the fleet with re-admissions
                # pending: refill before dispatching
                state = admission_tick(state)
                continue
            # A dispatch may not run past the next admit tick while an
            # admission may be pending (a free slot and a stream not yet known
            # to be exhausted): the tick is a host decision.  Once the stream
            # is exhausted, full-length dispatches resume for the drain.
            max_steps = cfg.sync_every
            if (not exhausted or retry_queue) and any(r is None for r in slot_req):
                max_steps = min(max_steps, cfg.admit_every - it % cfg.admit_every)

            def attempt_dispatch(attempt: _Attempt):
                # the injector fires first: an injected loss surfaces before
                # the engine touches the state, so a retry or an evacuation
                # reads it intact.  An attempt that the watchdog gave up on
                # returns here without touching it.
                if self.fault_injector is not None:
                    self.fault_injector.pre_dispatch(it, tuple(self._current_devs))
                if not attempt.claim():
                    return None
                return engine.run(state, max_steps, it)

            attempt = 0
            evacuated = False
            while True:
                try:
                    state, ms, executed, moved = _call_with_timeout(
                        attempt_dispatch, self.dispatch_timeout_s
                    )
                    break
                except (DeviceLostError, DispatchTimeout) as err:
                    dev = self._attribute_fault(err, it)
                    if attempt < self.max_dispatch_retries:
                        # transient until proven permanent: bounded retries
                        # with exponential backoff
                        attempt += 1
                        stats.add("dispatch_retries")
                        if self.retry_backoff_s > 0:
                            time.sleep(self.retry_backoff_s * 2 ** (attempt - 1))
                        continue
                    if dev is None:
                        raise  # unattributable: nothing to evacuate
                    state = evacuate_and_shrink(state, dev)
                    evacuated = True
                    break
            if evacuated:
                # no iteration ran: dispatch the same ``it`` again on the
                # smaller rank set (re-admissions wait for their admit tick,
                # as any queued request does)
                continue
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
                state = admission_tick(state)
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
