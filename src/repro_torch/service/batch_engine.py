"""Batched adaptive quadrature engine: a fleet of problems, one evaluate
launch per rank per iteration.

The port of the JAX package's ``repro.service.batch_engine``.  Fleets of
related integrals ``∫ f(x; theta_k) dx`` over one domain (parameter sweeps,
evidence grids) run here: every problem slot has its own region store, and
the stores of a rank are stacked along a leading slot axis
(:func:`~repro_torch.core.region_store.stacked_empty_state`).  The JAX
package ``vmap``s the single-store step over that axis; the port writes the
step once over it, as batched torch operations:

- *evaluate*: the fresh rows of every live slot's window go to the rule in
  **one** call over ``n_live × window`` rows, each slot's theta a column of
  a compact ``(n_theta, n_live)`` array (``eval_batch(theta_cols=...)``):
  one GM kernel launch, or the Gauss-Kronrod rule's torch operations with
  each row's theta broadcast against its nodes;
- *advance*: :func:`~repro_torch.core.split.split_compact_rows` over the
  slots that go on, with per-slot budgets and tolerances.

A rank owns a contiguous block of ``batch_slots / n_ranks`` slots on its
device (:mod:`repro_torch.core.ranks`: one host process drives every rank).
When a rank's live slots drain, whole problems migrate from its cyclic ring
partner: the paper's round-robin redistribution, lifted from regions to
problems (:meth:`BatchEngine._rebalance`).

The scheduler calls :meth:`BatchEngine.run`, a fused dispatch of up to
``cfg.sync_every`` iterations with one host read of their metrics, as the
JAX engine's ``lax.scan`` over ``lax.cond`` runs them.  Every slot
decision (converged, evicted, capped, the next population, done) is a
device tensor; each rank keeps its slots' ``done``, ``overflow_it`` and
population on its device, and the host's numpy masks mirror them.  After
each iteration's decisions the host waits on a pinned copy of those rows
(not a synchronising read), so it splits only the slots that go on, plans
each round from the masks after the iteration, sizes each window from exact
populations and stops at the first iteration in which a slot finishes
(:meth:`BatchEngine._dispatch`).  Any window that covers a slot gives that
slot the same bits, so a slot's trajectory does not depend on its
neighbours, its rank, its migrations or ``sync_every``: every result
equals the single-store :func:`~repro_torch.core.adaptive.integrate`'s
bit for bit, at any rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import gauss_kronrod, region_store
from repro_torch.core.adaptive import (
    LandedRows,
    advance_ladder,
    advance_target,
    eval_ladder,
    record_event,
    result_status,
)
from repro_torch.core.classify import classify, nonfinite_mask
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand, get_param
from repro_torch.core.ranks import Ranks, copy_to, cuda_devices
from repro_torch.core.redistribution import (
    exchange_pair_stats,
    make_schedule,
    ring_perms,
    round_shift,
)
from repro_torch.core.region_store import FIELDS, masked_sums, to_device
from repro_torch.core.rules import make_rule
from repro_torch.core.split import ROWS, SCALARS, split_compact_rows
from repro_torch.telemetry.core import NULL

# The per-slot metrics of one iteration in a dispatch's read: one row per
# value, one column per live slot.
_METRICS = (
    "integral", "error", "n_evals", "n_active", "it", "overflowed", "converged", "nonfinite",
)

# the per-slot host arrays of a BatchState
HOST_FIELDS = ("occupied", "done", "overflow_it", "counts")
# the rows of each rank's device copy of the slot decisions, (3, S_r) int64
DEVICE_ROWS = ("done", "overflow_it", "counts")


@dataclasses.dataclass
class BatchState:
    """The fleet: per-rank stacked stores on the devices, masks on the host.

    Slot ``s`` lives on rank ``s // slots_per_rank`` at local index
    ``s % slots_per_rank``.  ``done``, ``overflow_it`` and ``counts`` are
    the host's mirror of ``device_rows``, updated from each iteration's
    landed copy; ``occupied`` changes only by host decisions (admit,
    release, the moves the host plans), so it lives on the host alone.
    """

    regions: list  # per rank: RegionState, every field with a leading (S_r,) axis
    theta: list  # per rank: (n_theta, S_r), theta_fields order
    rel_tol: list  # per rank: (S_r,) per-request tolerances
    abs_tol: list  # per rank: (S_r,)
    occupied: np.ndarray  # (B,) bool: slot holds an admitted problem
    done: np.ndarray  # (B,) bool: result ready, frozen until released
    overflow_it: np.ndarray  # (B,) int64: it at first overflow, -1 = never
    counts: np.ndarray  # (B,) int64: active regions of each slot
    device_rows: list  # per rank: (3, S_r) int64 on its device, DEVICE_ROWS

    @property
    def n_slots(self) -> int:
        return self.occupied.shape[0]


def _family(cfg: QuadratureConfig, family) -> ParamIntegrand:
    if family is None:
        family = cfg.integrand.partition(":")[0]
    if isinstance(family, str):
        family = get_param(family)
    return family


def estimate_state_bytes(
    cfg: QuadratureConfig, family: Union[ParamIntegrand, str, None] = None
) -> int:
    """Device bytes of the engine's stacked state for ``cfg`` (the JAX
    package's count, so that a CLI can refuse a fleet before allocating
    ``batch_slots x capacity`` regions), plus, with the Gauss-Kronrod rule,
    the transient of its evaluation over every slot's store
    (:func:`~repro_torch.core.gauss_kronrod.transient_bytes`)."""
    cfg = cfg.validate()
    family = _family(cfg, family)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    C, d = cfg.capacity, cfg.d
    per_slot = (
        2 * C * d * item  # centers + halfw
        + 2 * C * item  # est + err
        + 4 * C  # axis (int32)
        + 2 * C  # active + fresh (bool)
        + 3 * item + 4 + 1  # fin_integral, fin_error, n_evals, it, overflowed
        + len(family.theta_fields) * d * item  # theta
        + 2 * item + 4 + 2  # rel_tol, abs_tol, overflow_it, occupied, done
    )
    transient = 0
    if cfg.rule == "gauss_kronrod":
        transient = gauss_kronrod.transient_bytes(d, cfg.batch_slots * C, item)
    return cfg.batch_slots * per_slot + transient


class BatchEngine:
    """Executor for a fixed-shape fleet of one integrand family.

    Every problem shares ``cfg``'s shape (d, capacity, domain) and differs in
    theta and tolerances.  The scheduler (:mod:`repro_torch.service.scheduler`)
    drives :meth:`run` from the host, admitting and collecting per slot.

    ``devices`` lists one torch device per rank (a device may repeat, e.g.
    ``["cpu"] * 4``).  The default is ``cfg.service_devices`` ranks (0 = one
    per visible GPU) on the visible GPUs, rank r on cuda:(r mod count); it
    raises when there is none.

    ``recorder`` (:mod:`repro_torch.telemetry`) gets an ``engine.build``
    span around the construction, as in the JAX engine; the scheduler
    records everything else.
    """

    backend = "cubature"

    def __init__(
        self,
        cfg: QuadratureConfig,
        family: Union[ParamIntegrand, str, None] = None,
        devices: Optional[Sequence] = None,
        recorder=NULL,
    ):
        cfg = cfg.validate()
        self.cfg = cfg
        self.family = _family(cfg, family)
        if devices is None:
            devices = cuda_devices(cfg.service_devices or torch.cuda.device_count())
        self.ranks = Ranks(devices)
        self.n_ranks = self.ranks.n
        self.n_slots = cfg.batch_slots
        if self.n_slots % self.n_ranks:
            raise ValueError(
                f"batch_slots={self.n_slots} must be a multiple of the rank "
                f"count ({self.n_ranks}): each rank owns a contiguous block of "
                "batch_slots / n_ranks slots"
            )
        self.slots_per_rank = self.n_slots // self.n_ranks
        # a pair can never usefully exchange more problems than one side owns
        self.rebalance_cap = min(cfg.rebalance_cap, self.slots_per_rank)
        self._rebalance_on = self.n_ranks > 1 and cfg.rebalance != "off"
        self.schedule = make_schedule(self.n_ranks)
        self.recorder = recorder
        with recorder.span(
            "engine.build", backend=self.backend, slots=self.n_slots, devices=self.n_ranks
        ):
            # since construction: the evaluate steps of each rank (one rule
            # evaluation each: one GM launch with the GM rule), the host
            # reads (one a dispatch) and the host's waits on a landed row of
            # decisions (one an iteration; an event, not a synchronising copy)
            self.eval_steps = np.zeros(self.n_ranks, np.int64)
            self.host_reads = self.landed_waits = 0

            lo = np.asarray(cfg.lo(), np.float64)
            hi = np.asarray(cfg.hi(), np.float64)
            self._total_volume = float(np.prod(hi - lo))
            self._dtype = getattr(torch, cfg.dtype)
            self._n_init = cfg.resolved_n_init()
            self._rule = make_rule(cfg, self.family)
            self._ladder = eval_ladder(cfg)
            self._adv_ladder = advance_ladder(cfg)
            self.theta_template = {
                k: np.zeros(np.shape(v), np.float64)
                for k, v in self.family.sample_theta(cfg.d, np.random.default_rng(0)).items()
            }
            self.n_theta = sum(v.size for v in self.theta_template.values())
            # per device: the fresh single-slot store spliced in on admit, and
            # the domain width the classifier reads
            self._fresh, self._width, self._admitted = {}, {}, {}
            for dev in self.ranks.devices:
                if dev not in self._fresh:
                    self._fresh[dev] = region_store.init_state(
                        cfg.capacity, lo, hi, self._n_init, self._dtype, dev
                    )
                    self._width[dev] = torch.as_tensor(hi - lo, device=dev)
                    # an admitted slot's device rows
                    self._admitted[dev] = to_device([0, -1, self._n_init], torch.int64, dev)
            first = self.ranks.first
            self._read_stream = torch.cuda.Stream(first) if first.type == "cuda" else None
            # per iteration of a dispatch: every rank's device rows
            self._landed = LandedRows(cfg.sync_every, 3 * self.n_slots, first)

    # --- state construction --------------------------------------------------

    def init(self) -> BatchState:
        """All slots empty; admit problems before stepping."""
        cfg, S, dt = self.cfg, self.slots_per_rank, self._dtype
        devs = self.ranks.devices
        B = self.n_slots
        state = BatchState(
            regions=[
                region_store.stacked_empty_state(S, cfg.capacity, cfg.d, dt, dev)
                for dev in devs
            ],
            theta=[torch.zeros((self.n_theta, S), dtype=dt, device=dev) for dev in devs],
            rel_tol=[torch.full((S,), cfg.rel_tol, dtype=dt, device=dev) for dev in devs],
            abs_tol=[torch.full((S,), cfg.abs_tol, dtype=dt, device=dev) for dev in devs],
            occupied=np.zeros(B, bool),
            done=np.zeros(B, bool),
            overflow_it=np.full(B, -1, np.int64),
            counts=np.zeros(B, np.int64),
            device_rows=[torch.zeros((3, S), dtype=torch.int64, device=dev) for dev in devs],
        )
        for rows in state.device_rows:
            rows[1].fill_(-1)  # overflow_it: never
        return state

    def _check_slot(self, slot: int) -> None:
        if not 0 <= int(slot) < self.n_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.n_slots})")

    def admit(
        self,
        state: BatchState,
        slot: int,
        theta,
        rel_tol: Optional[float] = None,
        abs_tol: Optional[float] = None,
    ) -> BatchState:
        """Write a fresh initial partition + theta into ``slot`` (mid-flight safe)."""
        self._check_slot(slot)
        got = {k: np.shape(v) for k, v in theta.items()}
        want = {k: v.shape for k, v in self.theta_template.items()}
        if got != want:
            raise ValueError(
                f"theta shape mismatch for family {self.family.name!r}: "
                f"got {got}, want {want}"
            )
        r, j = divmod(int(slot), self.slots_per_rank)
        dev = self.ranks.devices[r]
        region_store.write_slot(state.regions[r], j, self._fresh[dev])
        rel = self.cfg.rel_tol if rel_tol is None else rel_tol
        tol = self.cfg.abs_tol if abs_tol is None else abs_tol
        host = np.concatenate(
            [np.asarray(theta[k], np.float64).reshape(-1) for k in self.family.theta_fields]
            + [np.array([rel, tol], np.float64)]
        )
        col = to_device(host, self._dtype, dev)
        state.theta[r][:, j] = col[: self.n_theta]
        state.rel_tol[r][j] = col[self.n_theta]
        state.abs_tol[r][j] = col[self.n_theta + 1]
        state.device_rows[r][:, j] = self._admitted[dev]
        state.occupied[slot] = True
        state.done[slot] = False
        state.overflow_it[slot] = -1
        state.counts[slot] = self._n_init
        return state

    def release(self, state: BatchState, slot: int) -> BatchState:
        """Free a collected slot (its store stays stale until the next admit)."""
        self._check_slot(slot)
        r, j = divmod(int(slot), self.slots_per_rank)
        state.device_rows[r][0, j].zero_()  # a fill: no copy from the host
        state.occupied[slot] = False
        state.done[slot] = False
        return state

    # --- the fleet on the host (snapshots, rank-set changes) ------------------

    def host_shapes(self) -> dict[str, tuple]:
        """Name -> shape of every array of :meth:`to_host`."""
        B, C, d = self.n_slots, self.cfg.capacity, self.cfg.d
        rows = {"centers": (B, C, d), "halfw": (B, C, d)}
        shapes = {f"regions/{k}": rows.get(k, (B, C) if k in ROWS else (B,)) for k in FIELDS}
        shapes["theta"] = (B, self.n_theta)
        shapes.update({k: (B,) for k in ("rel_tol", "abs_tol", *HOST_FIELDS)})
        return shapes

    def to_host(self, state: BatchState) -> dict[str, np.ndarray]:
        """The fleet as slot-major host arrays with a leading ``B`` axis
        (rank r's rows at ``[r S, (r + 1) S)``): every field of the region
        stores as ``regions/<field>``, ``theta`` as ``(B, n_theta)``, the
        tolerances and the host masks.

        Every array is a copy: the engine updates the state in place, so a
        snapshot must not share memory with it (on a CPU rank ``t.cpu()``
        is ``t`` itself).
        """
        S = self.slots_per_rank

        def gather(per_rank) -> np.ndarray:
            out = torch.empty((self.n_slots, *per_rank[0].shape[1:]), dtype=per_rank[0].dtype)
            for r, t in enumerate(per_rank):
                out[r * S:(r + 1) * S].copy_(t)
            return out.numpy()

        host = {f"regions/{k}": gather([getattr(s, k) for s in state.regions]) for k in FIELDS}
        host["theta"] = gather([t.T for t in state.theta])
        host["rel_tol"] = gather(state.rel_tol)
        host["abs_tol"] = gather(state.abs_tol)
        for k in HOST_FIELDS:
            host[k] = getattr(state, k).copy()
        return host

    def place(self, host) -> BatchState:
        """Split :meth:`to_host`'s arrays over this engine's ranks, which may
        be more or fewer than the ranks that wrote them (the JAX engine's
        re-placement of a snapshot on the current mesh).  Copies: the host
        arrays stay as they are while the engine updates the state."""
        for k, shape in self.host_shapes().items():
            if tuple(np.shape(host[k])) != shape:
                raise ValueError(f"{k}: shape {np.shape(host[k])} != {shape}")
        S = self.slots_per_rank
        rows = np.stack([np.asarray(host[k], np.int64) for k in DEVICE_ROWS])
        regions, theta, rel_tol, abs_tol, device_rows = [], [], [], [], []
        for r, dev in enumerate(self.ranks.devices):
            sl = slice(r * S, (r + 1) * S)
            regions.append(region_store.RegionState(
                **{k: copy_to(host[f"regions/{k}"][sl], dev) for k in FIELDS}))
            theta.append(copy_to(host["theta"][sl].T, dev))
            rel_tol.append(copy_to(host["rel_tol"][sl], dev))
            abs_tol.append(copy_to(host["abs_tol"][sl], dev))
            device_rows.append(copy_to(rows[:, sl], dev))
        return BatchState(
            regions=regions, theta=theta, rel_tol=rel_tol, abs_tol=abs_tol,
            **{k: np.array(host[k]) for k in HOST_FIELDS}, device_rows=device_rows,
        )

    # --- one iteration ----------------------------------------------------------

    def _evaluate(self, state: BatchState, r: int, mine: np.ndarray, ew: int, wa: int):
        """Enqueue the first half of one iteration of the live slots ``mine``
        (local indices) of rank ``r``: evaluate, quarantine, classify and the
        slot decisions, whose device rows are written at once.

        Works on a copy of the leading ``wa`` rows of each live slot (``wa``
        covers every row the iteration touches; ``ew`` the rows to
        evaluate).  Every decision is a device tensor, with the host
        driver's arithmetic: ``converged``, the eviction clock, ``capped``,
        ``terminal``, the counter bump and the next population
        (:func:`~repro_torch.core.split.next_population`).

        Returns what :meth:`_advance` needs and the ``_METRICS`` rows of the
        live slots (float64).
        """
        cfg, rule, C = self.cfg, self._rule, self.cfg.capacity
        regions, rows = state.regions[r], state.device_rows[r]
        dev = self.ranks.devices[r]
        idx = to_device(mine, torch.long, dev)
        n, d = len(mine), cfg.d
        g = {k: getattr(regions, k)[idx, :wa] for k in ROWS}
        g.update({k: getattr(regions, k)[idx] for k in SCALARS + ("n_evals", "it")})
        done, ov, _ = rows[:, idx]

        # --- evaluate: one rule call over every live slot's eval window -----
        need = g["active"][:, :ew] & g["fresh"][:, :ew]
        est, err, axis = rule.eval_batch(
            g["centers"][:, :ew].reshape(n * ew, d),
            g["halfw"][:, :ew].reshape(n * ew, d),
            theta_cols=state.theta[r][:, idx],
        )
        for k, v in (("est", est), ("err", err), ("axis", axis)):
            g[k][:, :ew] = torch.where(need, v.view(n, ew), g[k][:, :ew])
        g["fresh"].zero_()
        g["n_evals"] = (
            g["n_evals"] + torch.sum(need, dim=1).to(g["n_evals"].dtype) * rule.n_evals_per_region
        )

        # --- non-finite quarantine --------------------------------------------
        # A NaN/Inf region estimate is contained to its own slot before the
        # reductions: its regions are zeroed and deactivated and the slot
        # ends with status "nonfinite".  For healthy slots every mask is
        # all-False and every where() an identity.
        bad = nonfinite_mask(g["est"], g["err"], g["active"])
        bad_fin = ~(torch.isfinite(g["fin_integral"]) & torch.isfinite(g["fin_error"]))
        nonfinite = torch.any(bad, dim=1) | bad_fin
        g["est"] = torch.where(bad, torch.zeros_like(g["est"]), g["est"])
        g["err"] = torch.where(bad, torch.zeros_like(g["err"]), g["err"])
        g["active"] = g["active"] & ~bad
        for k in ("fin_integral", "fin_error"):
            g[k] = torch.where(bad_fin, torch.zeros_like(g[k]), g[k])

        # --- global estimates, per-slot budget, classify ---------------------
        sums = masked_sums(g["active"], g["est"], g["err"])
        integral = g["fin_integral"] + sums[0]
        error = g["fin_error"] + sums[1]
        n_active = torch.sum(g["active"], dim=1)
        rel = state.rel_tol[r][idx]
        budget = torch.maximum(state.abs_tol[r][idx], torch.abs(integral) * rel)
        fin = classify(
            cfg, g["est"], g["err"], g["halfw"], g["active"], integral[:, None],
            self._total_volume, self._width[dev], budget=budget[:, None],
            rel_tol=rel[:, None],
        )

        # --- the slot decisions -----------------------------------------------
        it = g["it"].long()
        overflowed = g["overflowed"]
        converged = error <= budget
        # Capacity pressure is not instantly terminal: an overflowed slot
        # keeps refining for evict_patience iterations before eviction, as
        # the serial driver grinds past overflow and often converges.
        ov = torch.where(overflowed & (ov < 0), it, ov)
        evicted = overflowed & (it - ov >= cfg.evict_patience)
        # The serial driver runs exactly max_iters evaluate steps: post-eval
        # it == max_iters - 1 means this one was the last, so the slot
        # freezes now.
        capped = it >= cfg.max_iters - 1
        terminal = converged | (n_active == 0) | capped | evicted | nonfinite
        go = ~terminal
        # Serial parity on the counter: after its final estimates the serial
        # driver still runs (and counts) one advance before the loop ends.
        bump = capped & ~converged & (n_active > 0)
        it_after = it + go + bump
        left = torch.clamp(n_active - torch.sum(fin, dim=1), max=3 * C // 4)
        after = torch.where(go, left + torch.minimum(left, C - left), n_active)
        rows[:, idx] = torch.stack([done | terminal, ov, after])

        values = dict(
            integral=integral, error=error, n_evals=g["n_evals"], n_active=n_active,
            it=it_after, overflowed=overflowed, converged=converged, nonfinite=nonfinite,
        )
        read = torch.stack([values[k].double() for k in _METRICS])
        return (g, fin, it_after, idx), read

    def _advance(self, state: BatchState, r: int, wa: int, work, go: np.ndarray) -> None:
        """Enqueue the second half: split the slots flagged ``go`` (a host
        mask, from the landed decisions) and write every live slot back."""
        g, fin, it_after, idx = work
        regions = state.regions[r]
        if go.any():
            dev = idx.device
            sel = slice(None) if go.all() else to_device(np.flatnonzero(go), torch.long, dev)
            rows, scalars = split_compact_rows(
                self.cfg.capacity,
                {k: g[k][sel] for k in ROWS},
                {k: g[k][sel] for k in SCALARS},
                fin[sel],
            )
            for k, v in list(rows.items()) + list(scalars.items()):
                g[k][sel] = v
        g["it"] = it_after.to(regions.it.dtype)
        for k in ROWS:
            getattr(regions, k)[idx, :wa] = g[k]
        for k in SCALARS + ("n_evals", "it"):
            getattr(regions, k)[idx] = g[k]

    # --- the fused dispatch -----------------------------------------------------

    def _dispatch(self, state: BatchState, steps: int, tick: int, rebalance: bool):
        """Up to ``steps`` iterations of every live slot, with one host read.

        Each iteration enqueues every rank's evaluate and slot decisions,
        then copies every rank's device rows (``done``, ``overflow_it``, the
        next population) to pinned host memory with an event behind them
        (:class:`LandedRows`) and waits on that event (``landed_waits``: a
        wait, not a synchronising copy).  From the landed rows the host
        updates its mirror, splits only the slots that go on, plans the
        round from the masks after the iteration (the reference plans it
        after the flip, and finished slots never migrate), sizes the next
        windows from exact populations, and stops after the first iteration
        in which a slot finished: nothing is enqueued past it.  The
        per-slot metrics of every iteration come back in the dispatch's one
        read.
        """
        cfg, C, S, n, B = self.cfg, self.cfg.capacity, self.slots_per_rank, self.n_ranks, self.n_slots
        K = cfg.sync_every
        ladder, first = self._ladder, self.ranks.first
        moved = np.full((K, n * (self.rebalance_cap if n > 1 else 0), 2), -1, np.int64)
        executed = np.zeros(K, bool)
        metrics = {k: np.zeros((K, B), np.float64) for k in ("integral", "error", "n_evals")}
        metrics.update({k: np.zeros((K, B), np.int64) for k in ("n_active", "it")})
        metrics.update({k: np.zeros((K, B), bool) for k in
                        ("overflowed", "converged", "nonfinite", "done", "occupied")})
        metrics["window"] = np.zeros((K, n), np.int64)
        if not (state.occupied & ~state.done).any():  # every iteration a pass-through
            executed[:steps] = True
            metrics["done"][:steps] = state.done
            metrics["occupied"][:steps] = state.occupied
            metrics["window"][:steps] = ladder[0]
            return state, metrics, executed, moved

        landed = self._landed
        landed.start()
        reads, kept = [], []  # the metrics tensors; per iteration, each rank's slots
        for t in range(steps):
            live = state.occupied & ~state.done
            metrics["occupied"][t] = state.occupied
            work = []
            for r in range(n):
                mine = np.flatnonzero(live[r * S:(r + 1) * S])
                widest = int(state.counts[r * S + mine].max()) if len(mine) else 0
                ew = metrics["window"][t, r] = region_store.select_window(ladder, widest)
                if len(mine):
                    self.eval_steps[r] += 1
                    wa = region_store.select_window(self._adv_ladder, advance_target(widest, C))
                    work.append((r, r * S + mine, wa) + self._evaluate(state, r, mine, ew, wa))
            landed.record(torch.cat(
                [rows.to(first, non_blocking=True).flatten() for rows in state.device_rows]))
            reads.append(torch.cat([w[4].to(first, non_blocking=True).flatten() for w in work]))
            kept.append([w[1] for w in work])
            read_after = record_event(first)  # behind this iteration's metrics
            landed.wait(t + 1)
            self.landed_waits += 1
            rows = landed.rows[t].reshape(n, 3, S).transpose(1, 0, 2).reshape(3, B)
            finished = live & (rows[0] > 0)
            state.done[:] = rows[0] > 0
            state.overflow_it[:] = rows[1]
            state.counts[:] = rows[2]
            for r, slots, wa, w, _ in work:
                self._advance(state, r, wa, w, ~finished[slots])
            executed[t] = True
            metrics["done"][t] = state.done
            if rebalance:
                moved[t] = self._rebalance(state, tick + t)
            if finished.any():
                break

        # --- the dispatch's one read, on a stream that waits only for the last
        # iteration's metrics: the card runs its advance on while the host goes on
        if read_after is None:
            host = torch.cat(reads).cpu().numpy()
        else:
            self._read_stream.wait_event(read_after)
            with torch.cuda.stream(self._read_stream):
                host = torch.cat(reads).cpu().numpy()
        self.host_reads += 1
        at = 0
        for t, slots_t in enumerate(kept):
            for slots in slots_t:
                block = host[at:at + len(_METRICS) * len(slots)].reshape(len(_METRICS), -1)
                at += block.size
                for i, key in enumerate(_METRICS):
                    metrics[key][t, slots] = block[i]
        return state, metrics, executed, moved

    def step(self, state: BatchState):
        """One iteration of every live slot (no migration); returns
        ``(state, metrics)`` with per-slot host arrays (see :meth:`run`) and
        the scalar eval ``window`` of the first rank."""
        state, ms, _, _ = self._dispatch(state, 1, 0, rebalance=False)
        row = {k: v[0] for k, v in ms.items()}
        return state, {**row, "window": int(row["window"][0])}

    # --- problem-level cyclic rebalancing ------------------------------------

    def _move(self, state: BatchState, src: int, dst: int) -> None:
        """Copy slot ``src``'s problem into the free slot ``dst`` (device to
        device), with its device rows (``done`` cleared), and hand over its
        host masks."""
        S = self.slots_per_rank
        (rs, js), (rd, jd) = divmod(src, S), divmod(dst, S)
        a, b = state.regions[rs], state.regions[rd]
        for k in FIELDS:
            getattr(b, k)[jd].copy_(getattr(a, k)[js], non_blocking=True)
        state.theta[rd][:, jd].copy_(state.theta[rs][:, js], non_blocking=True)
        for k in ("rel_tol", "abs_tol"):
            getattr(state, k)[rd][jd].copy_(getattr(state, k)[rs][js], non_blocking=True)
        col = state.device_rows[rs][:, js].clone()
        col[0].zero_()
        state.device_rows[rd][:, jd].copy_(col, non_blocking=True)
        state.occupied[src] = False
        state.occupied[dst] = True
        state.done[dst] = False
        state.overflow_it[dst] = state.overflow_it[src]
        state.counts[dst] = state.counts[src]

    def _rebalance(self, state: BatchState, tick: int) -> np.ndarray:
        """One migration round at the fleet-global iteration ``tick``: the
        paper's cyclic round-robin pairing, lifted from regions to whole
        problems.

        A rank whose live-slot count fell below the fair share
        (``total // n_ranks``) receives up to ``rebalance_cap`` problems
        from its ring partner at the scheduled shift: the donor's
        highest-index live slots go into the receiver's lowest-index free
        slots.  The counts are host arithmetic on the host's masks; the
        payload (the slot's store rows, theta, tolerances and device rows)
        is a device to device copy.  Returns ``(n_ranks * rebalance_cap,
        2)`` records ``(src_slot, dst_slot)``, -1 in unused rows, by
        receiving rank.
        """
        n, S, cap = self.n_ranks, self.slots_per_rank, self.rebalance_cap
        shift = round_shift(self.schedule, tick)
        occ = state.occupied.reshape(n, S)
        live = occ & ~state.done.reshape(n, S)
        n_live = live.sum(axis=1)
        n_free = (~occ).sum(axis=1)
        fair = int(n_live.sum()) // n  # floor: migrate only into real holes
        surplus = np.maximum(n_live - fair, 0)
        deficit = np.maximum(fair - n_live, 0)
        stats = list(zip(n_live, n_free, surplus, deficit))
        down_stats, up_stats = exchange_pair_stats(stats, n, shift)
        idx = np.arange(S)
        moves = []
        for donor, recv in ring_perms(n, shift)[1]:
            n_send = min(cap, surplus[donor], down_stats[donor][3], down_stats[donor][1])
            n_recv = min(cap, up_stats[recv][2], deficit[recv], n_free[recv])
            assert n_send == n_recv, (n_send, n_recv)
            src = np.argsort(np.where(live[donor], -idx, S + 1), kind="stable")[:n_send]
            dst = np.argsort(np.where(occ[recv], S + 1, idx), kind="stable")[:n_recv]
            moves += [(recv, j, donor * S + s, recv * S + t)
                      for j, (s, t) in enumerate(zip(src, dst))]
        moved = np.full((n * cap, 2), -1, np.int64)
        for recv, j, src, dst in moves:
            self._move(state, int(src), int(dst))
            moved[recv * cap + j] = (src, dst)
        return moved

    # --- the multi-iteration dispatch -------------------------------------------

    def run(self, state: BatchState, max_steps: int, tick: int):
        """Up to ``min(max_steps, cfg.sync_every)`` iterations, fused: one
        host read per call (see :meth:`_dispatch`).

        Stops after the first iteration in which a slot's ``done`` flips on,
        so the host scheduler observes every collection at its exact
        iteration.  Returns ``(state, metrics, executed, moved)``, shaped as
        the JAX engine's:

        - ``metrics``: per-slot host arrays stacked over the iterations,
          ``(sync_every, batch_slots)`` (``window``: ``(sync_every,
          n_ranks)``, each rank's rung of its widest exact population),
          zero in rows that did not run: ``integral``, ``error``,
          ``n_active``, ``it``, ``n_evals``, ``overflowed``, ``converged``,
          ``nonfinite`` (the values of the slots live in that iteration,
          zeros elsewhere), ``done`` and ``occupied``;
        - ``executed``: ``(sync_every,)`` prefix mask of the iterations run;
        - ``moved``: ``(sync_every, n_ranks * rebalance_cap, 2)``
          ``(src_slot, dst_slot)`` migration records per iteration (-1 =
          unused; no rows with one rank).

        ``tick`` is the fleet-global number of the first iteration (it
        indexes the cyclic migration schedule).
        """
        steps = min(int(max_steps), self.cfg.sync_every)
        if steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        return self._dispatch(state, steps, tick, self._rebalance_on)

    def status_of(
        self,
        converged: bool,
        n_active: int,
        it: int,
        overflowed: bool,
        nonfinite: bool = False,
    ) -> str:
        """Terminal status of a collected slot (the scheduler's hook)."""
        return result_status(converged, n_active, it, self.cfg, overflowed, nonfinite)
