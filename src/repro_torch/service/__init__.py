"""Batch quadrature service: continuous batching for fleets of integrals,
over one or more ranks.

- :mod:`repro_torch.service.batch_engine`: the stacked region stores, one
  GM launch per rank per iteration over every live slot, per-slot ``done``
  masks, and problem-level cyclic migration between ranks;
- :mod:`repro_torch.service.scheduler`: the continuous-batching host loop,
  with a dispatch watchdog that retries transient faults and, when a rank
  is lost, evacuates its slots and rebuilds the engine on the surviving
  ranks (regrowing later);
- :mod:`repro_torch.service.api`: ``integrate_batch`` / ``serve``;
- :mod:`repro_torch.service.routing`: graceful re-routing of degraded
  requests (cubature evictions to the VEGAS pool, relaxed retries);
- :mod:`repro_torch.service.checkpoint`: service snapshots and resume;
- :mod:`repro_torch.service.faults`: deterministic fault injectors, run by
  :mod:`repro_torch.service.chaos_selftest`;
- :mod:`repro_torch.service.sharded_selftest`: the JAX package's sharded
  service cases on N ranks.

Results are the same at every rank count, for every terminal status.
"""

from repro_torch.service.api import integrate_batch, serve
from repro_torch.service.batch_engine import BatchEngine, BatchState
from repro_torch.service.checkpoint import ServiceCheckpointer
from repro_torch.service.routing import GracefulScheduler, ReroutePolicy
from repro_torch.service.scheduler import (
    BatchScheduler,
    DeviceLostError,
    DispatchTimeout,
    QuadRequest,
    QuadResult,
)

__all__ = [
    "BatchEngine",
    "BatchScheduler",
    "BatchState",
    "DeviceLostError",
    "DispatchTimeout",
    "GracefulScheduler",
    "QuadRequest",
    "QuadResult",
    "ReroutePolicy",
    "ServiceCheckpointer",
    "integrate_batch",
    "serve",
]
