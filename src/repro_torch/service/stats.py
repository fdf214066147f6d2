"""ServiceStats: the one typed schema for the service host loop's counters.

The port's own copy of the JAX package's ``repro.telemetry.stats`` (the port
imports nothing of that package).  The schema is a dataclass: ``merge`` is
field-wise by construction, and an unknown key in a stored dict is a loud
error instead of silent drift.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class ServiceStats:
    """Host-loop counters for one service run.

    All counters are integers; ``as_dict`` is the view exposed as
    ``BatchScheduler.last_stats``.  The fields are the JAX package's, so
    that the two packages' stats compare.
    """

    iterations: int = 0  # fleet iterations executed (all slots advance together)
    dispatches: int = 0  # fused engine launches
    admissions: int = 0  # requests admitted into slots (incl. retries)
    collections: int = 0  # terminal slots collected (any status)
    migrations: int = 0  # problems moved between devices by the rebalancer
    quarantines: int = 0  # slots collected with status "nonfinite"
    deadlines: int = 0  # slots evicted on an expired SLO
    checkpoints: int = 0  # service snapshots written
    reroutes: int = 0  # fallback re-admissions (graceful layer)
    dispatch_retries: int = 0  # dispatches re-attempted after a transient fault
    evacuations: int = 0  # slots recovered/re-admitted off a failed device
    mesh_shrinks: int = 0  # engine rebuilds onto a smaller surviving sub-mesh
    mesh_regrows: int = 0  # engine rebuilds back onto a restored device

    def add(self, name: str, n: int = 1) -> int:
        """Bump counter ``name`` by ``n``; unknown names raise AttributeError."""
        value = getattr(self, name) + n
        setattr(self, name, value)
        return value

    def merge(self, other: "ServiceStats") -> None:
        """Field-wise accumulate ``other`` into ``self``."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, obj: Dict[str, int]) -> "ServiceStats":
        """Rebuild from a stored dict (checkpoint meta sidecar).

        Missing keys default to 0 (snapshots written before a counter
        existed); unknown keys raise — that is the key-drift guard.
        """
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"unknown ServiceStats keys {sorted(unknown)}; known: {sorted(known)}"
            )
        return cls(**{k: int(v) for k, v in obj.items()})
