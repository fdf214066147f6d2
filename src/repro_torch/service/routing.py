"""Fallback re-routing: retry degraded requests on the pool that can serve them.

The port of the JAX package's ``repro.service.routing``.  A
terminal-but-unconverged request is not simply reported as a failure when
another engine pool can still produce a converged estimate:

- a cubature slot evicted as ``capacity`` hit region-store saturation, the
  signature of a high-dimensional or irregular problem that importance
  sampling handles without a region store, so it is admitted once more, to
  the VEGAS pool;
- a ``nonfinite`` quarantine may come from cubature's fixed nodes hitting a
  pole; the VEGAS pool samples other points and may miss it (if the
  integrand is NaN everywhere, the retry quarantines again and the request
  is reported ``nonfinite`` with its provenance);
- a request that exhausts its iterations (``max_iters``) is retried once on
  its own backend at a loosened tolerance, trading accuracy for an answer.

Every retry consumes the request's attempt budget; the final
:class:`~repro_torch.service.scheduler.QuadResult` carries the provenance
(``backend``, ``attempts``, ``retried_from``, and ``evacuated`` from a rank
loss in an earlier attempt).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Sequence, Union

from repro_torch.core.config import QuadratureConfig
from repro_torch.core.integrands import ParamIntegrand
from repro_torch.service.scheduler import BatchScheduler, QuadRequest, QuadResult
from repro_torch.service.stats import ServiceStats


@dataclasses.dataclass(frozen=True)
class ReroutePolicy:
    """When and how a terminal-but-degraded request earns another attempt.

    ``max_attempts`` bounds the admissions per request (1 = never retry).
    ``reroute_statuses`` re-admit a cubature request to the VEGAS pool;
    ``relax_statuses`` re-admit to the *same* backend with tolerances
    loosened by ``tol_relax``.
    """

    max_attempts: int = 2
    reroute_statuses: tuple = ("capacity", "nonfinite")
    relax_statuses: tuple = ("max_iters",)
    tol_relax: float = 10.0

    def validate(self) -> "ReroutePolicy":
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.tol_relax < 1.0:
            raise ValueError(f"tol_relax must be >= 1, got {self.tol_relax}")
        return self


class GracefulScheduler:
    """A :class:`BatchScheduler` with fallback re-routing.

    Serves the request stream through the primary pool, then re-admits the
    degraded requests (per :class:`ReroutePolicy`): cubature
    ``capacity`` / ``nonfinite`` evictions to a single-rank VEGAS pool on
    the primary's first device, built lazily; requests that ran out of
    iterations to a relaxed-tolerance pass on their own backend.  Results
    that need no retry are yielded as soon as the primary collects them;
    retried requests after their final attempt, with provenance.

    ``last_stats`` sums the :class:`ServiceStats` of every pool field by
    field, plus ``reroutes`` (fallback re-admissions of both kinds).
    Keyword arguments (``on_tick``, the checkpointer, and the rank-loss
    arguments ``fault_injector``, ``max_dispatch_retries``,
    ``dispatch_timeout_s``) go to the primary pool only: the VEGAS pool has
    one rank, and a retry pass after a shrink runs on the primary's
    surviving ranks.
    """

    def __init__(
        self,
        cfg: QuadratureConfig,
        family: Union[ParamIntegrand, str, None] = None,
        devices: Optional[Sequence] = None,
        policy: Optional[ReroutePolicy] = None,
        **scheduler_kwargs,
    ):
        self.policy = (policy or ReroutePolicy()).validate()
        self.primary = BatchScheduler(cfg, family, devices=devices, **scheduler_kwargs)
        self.cfg = self.primary.cfg
        self.family = self.primary.engine.family
        self._vegas_pool: Optional[BatchScheduler] = None
        self._stats = ServiceStats()

    @property
    def last_stats(self) -> dict:
        """Dict view of the latest run's aggregated stats."""
        return self._stats.as_dict()

    def _vegas(self) -> BatchScheduler:
        """The fallback MC pool, on the primary's first rank."""
        if self._vegas_pool is None:
            cfg = dataclasses.replace(self.cfg, backend="vegas", service_devices=1)
            self._vegas_pool = BatchScheduler(
                cfg, self.family, devices=[self.primary.engine.ranks.first]
            )
        return self._vegas_pool

    def serve(
        self, requests: Iterable[QuadRequest], resume: bool = False
    ) -> Iterator[QuadResult]:
        policy = self.policy
        stats = ServiceStats()
        self._stats = stats
        by_id: dict[int, QuadRequest] = {}

        def recording(stream):
            for req in stream:
                by_id[req.req_id] = req
                yield req

        def retried(results, prior):
            # a request evacuated off a lost rank in its prior attempt keeps
            # that provenance through the retry
            for res in results:
                yield dataclasses.replace(
                    res,
                    attempts=prior[res.req_id].attempts + 1,
                    retried_from=prior[res.req_id].status,
                    evacuated=res.evacuated or prior[res.req_id].evacuated,
                )

        primary_backend = self.primary.engine.backend
        reroute: list[QuadResult] = []  # cubature -> vegas pool
        relax: list[QuadResult] = []  # same backend, loosened tolerances
        for res in self.primary.serve(recording(requests), resume=resume):
            if policy.max_attempts > 1 and res.status in policy.relax_statuses:
                relax.append(res)
            elif (
                policy.max_attempts > 1
                and primary_backend == "cubature"
                and res.status in policy.reroute_statuses
            ):
                reroute.append(res)
            else:
                yield res
        stats.merge(ServiceStats.from_dict(self.primary.last_stats))

        # The fallback passes run after the primary fleet drains: the retry
        # population is small by construction, so a dedicated pass beats
        # holding primary slots.  Each serve() builds fresh state.
        if reroute:
            stats.add("reroutes", len(reroute))
            pool = self._vegas()
            yield from retried(
                pool.serve([by_id[r.req_id] for r in reroute]),
                {r.req_id: r for r in reroute},
            )
            stats.merge(ServiceStats.from_dict(pool.last_stats))

        if relax:
            stats.add("reroutes", len(relax))
            cfg = self.cfg
            retries = []
            for r in relax:
                req = by_id[r.req_id]
                rel = cfg.rel_tol if req.rel_tol is None else req.rel_tol
                tol = cfg.abs_tol if req.abs_tol is None else req.abs_tol
                retries.append(dataclasses.replace(
                    req, rel_tol=rel * policy.tol_relax, abs_tol=tol * policy.tol_relax))
            yield from retried(self.primary.serve(retries), {r.req_id: r for r in relax})
            stats.merge(ServiceStats.from_dict(self.primary.last_stats))
