"""Batch quadrature service: continuous batching for fleets of integrals,
over one or more ranks.

- :mod:`repro_torch.service.batch_engine`: the stacked region stores, one
  GM launch per rank per iteration over every live slot, per-slot ``done``
  masks, and problem-level cyclic migration between ranks;
- :mod:`repro_torch.service.scheduler`: the continuous-batching host loop;
- :mod:`repro_torch.service.api`: ``integrate_batch`` / ``serve``;
- :mod:`repro_torch.service.routing`: graceful re-routing of degraded
  requests (cubature evictions to the VEGAS pool, relaxed retries);
- :mod:`repro_torch.service.sharded_selftest`: the JAX package's sharded
  service cases on N ranks.

Results are the same at every rank count, for every terminal status.
"""

from repro_torch.service.api import integrate_batch, serve
from repro_torch.service.batch_engine import BatchEngine, BatchState
from repro_torch.service.routing import GracefulScheduler, ReroutePolicy
from repro_torch.service.scheduler import BatchScheduler, QuadRequest, QuadResult

__all__ = [
    "BatchEngine",
    "BatchScheduler",
    "BatchState",
    "GracefulScheduler",
    "QuadRequest",
    "QuadResult",
    "ReroutePolicy",
    "integrate_batch",
    "serve",
]
