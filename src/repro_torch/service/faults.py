"""Deterministic fault injectors for the quadrature service.

The port of the JAX package's ``repro.service.faults``.  Every injector is
a function of its explicit inputs (a seed, a slot, an iteration), with no
wall clock and no global state, so a chaos run that trips an assertion
replays bit for bit.  Used by :mod:`repro_torch.service.chaos_selftest`:

- **NaN integrands**: :func:`nan_family` wraps a family so that thetas
  carrying :data:`NAN_SENTINEL` evaluate to NaN, and :func:`poison_theta`
  plants the sentinel;
- **slot corruption**: :func:`corrupt_slot` overwrites one slot's durable
  state with NaN (a soft memory error, a bad kernel), exercising the
  engines' quarantine;
- **crash points**: :func:`crash_at` raises :class:`SimulatedCrash` from
  the scheduler's ``on_tick`` hook, exercising checkpoints and resume;
- **queue storms**: :func:`storm_requests`, a burst of requests far beyond
  the fleet's slots;
- **rank loss**: :class:`DeviceDown` makes one rank fail (raise, or hang
  the dispatch) at an iteration, transiently or for good, and optionally
  heal later: the scheduler's watchdog, evacuation, shrink and regrow.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.integrands import ParamIntegrand, _col

# The loss and timeout errors live with the scheduler's watchdog; they are
# re-exported here, beside the injectors that raise them.
from repro_torch.service.scheduler import DeviceLostError, DispatchTimeout, QuadRequest

__all__ = [
    "NAN_SENTINEL",
    "SimulatedCrash",
    "DeviceLostError",
    "DispatchTimeout",
    "DeviceDown",
    "nan_family",
    "poison_theta",
    "corrupt_slot",
    "corrupt_slot_hook",
    "crash_at",
    "storm_requests",
]

#: Theta value that triggers the NaN wrapper: no sampled problem reaches it,
#: and it stays finite in float64, so the sentinel itself never overflows
#: before the check.
NAN_SENTINEL = 1e300


class SimulatedCrash(RuntimeError):
    """Raised by fault hooks to kill the serve loop at a deterministic point."""


def nan_family(family: ParamIntegrand) -> ParamIntegrand:
    """``family`` with sentinel-carrying thetas evaluating to NaN.

    The poison travels in the request's theta, so one wrapped family serves
    healthy and poisoned requests side by side in one fleet, the case the
    quarantine must survive.  It takes two routes, and both leave a healthy
    theta's values bit for bit as they were:

    - the wrapped ``fn``, which torch evaluates (the VEGAS pool, the GM
      rule's plain version on the CPU): ``where(poisoned, nan, f)``;
    - ``nan_sentinel``, read by the GM evaluate
      (:func:`repro_torch.kernels.ops.genz_malik_eval`), which sets to NaN
      every output lane of a theta holding the sentinel, after the CUDA
      kernel (which keeps the base family's ``kernel_id``) or the plain
      version has run.  NaN in theta before the launch would not do:
      ``pow(1, NaN)`` is 1, so ``monomial`` at x = 1 would stay finite.
    """
    base = family.fn

    def fn(x, theta):
        poisoned = torch.zeros((), dtype=torch.bool, device=x.device)
        for leaf in theta.values():
            poisoned = poisoned | torch.any(_col(leaf, x) >= NAN_SENTINEL, dim=0)
        return torch.where(poisoned, torch.nan, base(x, theta))

    return dataclasses.replace(
        family,
        name=family.name + "+nanfault",
        fn=fn,
        description=f"{family.name} with sentinel-triggered NaN injection",
        nan_sentinel=NAN_SENTINEL,
    )


def poison_theta(theta: dict) -> dict:
    """Plant :data:`NAN_SENTINEL` in the first leaf of a theta dict (first
    in key order, as the JAX package flattens a dict)."""
    first = min(theta)
    bad = np.full_like(np.asarray(theta[first], np.float64), NAN_SENTINEL)
    return {k: bad if k == first else v for k, v in theta.items()}


def corrupt_slot(state, slot: int):
    """Overwrite one slot's estimator state with NaN, in place.

    Cubature (:class:`~repro_torch.service.batch_engine.BatchState`): the
    slot's durable state, its region centres (every active region is split
    and evaluated anew, so a per-region estimate alone would be recomputed
    from clean geometry) and its finalised integral.  VEGAS
    (:class:`~repro_torch.mc.engine.VegasBatchState`): the slot's
    weighted-average accumulators.  Returns the state.
    """
    if hasattr(state, "regions"):  # cubature fleet
        per_rank = state.regions[0].centers.shape[0]
        r, j = divmod(int(slot), per_rank)
        state.regions[r].centers[j] = torch.nan
        state.regions[r].fin_integral[j] = torch.nan
        return state
    if hasattr(state, "mc"):  # vegas fleet
        state.mc.sum_wi[slot] = torch.nan
        state.mc.sum_wi2[slot] = torch.nan
        return state
    raise TypeError(f"unrecognised fleet state {type(state).__name__}")


def corrupt_slot_hook(slot: int, at_iteration: int, req_id: Optional[int] = None):
    """``on_tick`` hook: corrupt ``slot`` once, at the first tick >= threshold.

    With ``req_id`` set, the hook waits until that request occupies the
    slot, so the injection cannot land on a request admitted into the slot
    after the intended victim drained.
    """
    fired = {"done": False}

    def hook(it, state, slot_req):
        if fired["done"] or it < at_iteration:
            return None
        req = slot_req[slot]
        if req is None or (req_id is not None and req.req_id != req_id):
            return None
        fired["done"] = True
        return corrupt_slot(state, slot)

    return hook


@dataclasses.dataclass
class DeviceDown:
    """Deterministic rank-loss injector for the scheduler's watchdog.

    Plugs into ``BatchScheduler(fault_injector=...)``: the scheduler calls
    :meth:`pre_dispatch` at every dispatch boundary, before the engine
    touches the state, so a retry or an evacuation reads intact state; and
    it probes :meth:`healthy` to attribute hangs and to decide a regrow.

    ``device`` indexes the engine's *original* ranks (a rank is the "device"
    of the JAX package's mesh: one host process drives every rank, and a
    lost rank is one this injector marks down).  From iteration ``at_tick``
    the rank is down:

    - ``transient_failures=0`` (default): for good, until
      ``restore_at_tick`` if set; from then :meth:`healthy` reports it back
      and a later admission tick regrows the rank set onto it;
    - ``transient_failures=k``: for exactly ``k`` dispatch attempts; a
      watchdog with ``max_dispatch_retries >= k`` rides it out, the run
      bit-identical to a fault-free one.

    ``mode="raise"`` raises :class:`DeviceLostError`; ``mode="hang"`` sleeps
    ``hang_s`` instead (a wedged dispatch: pair it with
    ``dispatch_timeout_s``, so that the watchdog turns the hang into a
    :class:`DispatchTimeout`).
    """

    device: int
    at_tick: int
    transient_failures: int = 0  # 0 = permanent
    restore_at_tick: Optional[int] = None  # heal point (permanent mode)
    mode: str = "raise"  # "raise" | "hang"
    hang_s: float = 30.0
    _fired: int = dataclasses.field(default=0, init=False, repr=False)

    def __post_init__(self):
        if self.mode not in ("raise", "hang"):
            raise ValueError(f"mode must be 'raise' or 'hang', got {self.mode!r}")

    def _down(self, it: int) -> bool:
        if it < self.at_tick:
            return False
        if self.transient_failures > 0:
            return self._fired < self.transient_failures
        if self.restore_at_tick is not None and it >= self.restore_at_tick:
            return False
        return True

    def healthy(self, device: int, it: int) -> bool:
        """Scheduler probe: is rank ``device`` serving at iteration ``it``?"""
        return device != self.device or not self._down(it)

    def pre_dispatch(self, it: int, device_indices: Sequence[int]) -> None:
        """Fail the dispatch when the down rank is one of the current ranks."""
        if self.device not in device_indices or not self._down(it):
            return
        self._fired += 1
        if self.mode == "hang":
            time.sleep(self.hang_s)
            return
        raise DeviceLostError(
            self.device, f"injected device loss: device {self.device} at iteration {it}"
        )


def crash_at(at_iteration: int):
    """``on_tick`` hook raising :class:`SimulatedCrash` at a fixed iteration."""

    def hook(it, state, slot_req):
        if it >= at_iteration:
            raise SimulatedCrash(f"injected crash at iteration {it}")
        return None

    return hook


def storm_requests(
    family: ParamIntegrand,
    d: int,
    n: int,
    seed: int = 0,
    rel_tol: Optional[float] = None,
    abs_tol: Optional[float] = None,
    req_id_base: int = 0,
) -> Iterator[QuadRequest]:
    """A deterministic burst of ``n`` sampled problem instances."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield QuadRequest(
            req_id=req_id_base + i,
            theta=family.sample_theta(d, rng),
            rel_tol=rel_tol,
            abs_tol=abs_tol,
        )
