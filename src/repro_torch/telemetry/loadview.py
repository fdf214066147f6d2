"""Derived load/idle views: per-rank occupancy and imbalance timelines.

The port's own copy of the JAX package's ``repro.telemetry.loadview``.  The
service scheduler records a ``service.n_live`` gauge per rank at every
executed iteration (host-side, from the host masks the engine already
returns).  This module turns that event stream into the views the paper
plots:

- :func:`occupancy_from_events` — the raw per-device live-slot timeline;
- :func:`idle_fraction` — per-device fraction of slot-iterations idle
  (1 - occupied/total), the live-service analogue of paper Fig. 4b;
- :func:`imbalance` / :func:`imbalance_series` / :func:`mean_imbalance` —
  the exact ``1 - mean/max`` work-imbalance statistic the offline
  ``benchmarks/fig4b_idle.py`` script reports (via
  ``DistributedResult.mean_imbalance``), so live-telemetry numbers and
  offline-benchmark numbers are the same computation on the same series.

Everything is pure Python over the recorded events — no torch, no numpy —
so it is usable on a metrics JSONL file long after the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Sequence

#: gauge name the service scheduler records per device per iteration
N_LIVE = "service.n_live"
#: gauge name the distributed driver records per iteration (scalar)
WORK_IMB = "dist.work_imb"


def imbalance(per_device_work: Sequence[float]) -> float:
    """Paper Fig. 4b idle-time proxy for one iteration: ``1 - mean/max``.

    Matches the work imbalance of
    :func:`repro_torch.core.distributed.integrate_distributed`:
    ``1 - (sum/n)/max(max, 1)`` when ``max > 0``, else 0.  0 = perfectly
    balanced, -> 1 = one device does all the work.
    """
    n = len(per_device_work)
    if n == 0:
        return 0.0
    mx = max(per_device_work)
    if mx <= 0:
        return 0.0
    return 1.0 - (sum(per_device_work) / n) / max(mx, 1)


@dataclass
class Timeline:
    """Per-device series sampled at iteration boundaries.

    ``values[t][d]`` is device ``d``'s sample at ``iterations[t]``.
    """

    devices: List[int]
    iterations: List[int]
    values: List[List[float]]

    def series(self, device: int) -> List[float]:
        j = self.devices.index(device)
        return [row[j] for row in self.values]


def occupancy_from_events(
    events: Iterable[Dict[str, Any]], name: str = N_LIVE
) -> Timeline:
    """Build the per-device occupancy timeline from recorded gauge events.

    Expects gauges named ``name`` with ``lane`` = device index and an
    ``it`` attr = global iteration number (what the scheduler records).
    """
    samples: Dict[int, Dict[int, float]] = {}
    devices: set = set()
    for e in events:
        if e.get("kind") != "gauge" or e.get("name") != name:
            continue
        it = int(e["it"])
        dev = int(e["lane"])
        devices.add(dev)
        samples.setdefault(it, {})[dev] = float(e["value"])
    devs = sorted(devices)
    its = sorted(samples)
    values = [[samples[it].get(d, 0.0) for d in devs] for it in its]
    return Timeline(devices=devs, iterations=its, values=values)


def idle_fraction(
    timeline: Timeline, slots_per_device: int
) -> Dict[int, float]:
    """Per-device idle fraction over the run: 1 - occupied/(iters*slots).

    A slot-iteration is *occupied* when the slot held a live (admitted,
    not yet converged) problem at that iteration; everything else —
    empty slots, slots whose problem already finished — is idle capacity.
    """
    n_it = len(timeline.iterations)
    if n_it == 0:
        return {d: 0.0 for d in timeline.devices}
    out = {}
    for j, d in enumerate(timeline.devices):
        occupied = sum(row[j] for row in timeline.values)
        out[d] = 1.0 - occupied / (n_it * slots_per_device)
    return out


def imbalance_series(timeline: Timeline) -> List[float]:
    """Per-iteration Fig. 4b imbalance over the timeline's device rows."""
    return [imbalance(row) for row in timeline.values]


def mean_imbalance(timeline: Timeline) -> float:
    series = imbalance_series(timeline)
    if not series:
        return 0.0
    return sum(series) / len(series)


def hist_values_from_events(
    events: Iterable[Dict[str, Any]], name: str
) -> List[float]:
    """All values of histogram ``name`` recorded in an event stream.

    The offline (metrics-JSONL) half of the latency views: feed the result
    to :func:`repro_torch.telemetry.core.quantile` for the same p50/p99 the live
    recorder's ``quantile`` reports — e.g. the ``service.dispatch_wall_s``
    / ``service.queue_wait_s`` histograms the scheduler records at dispatch
    boundaries, which the perf report renders.
    """
    return [
        float(e["value"])
        for e in events
        if e.get("kind") == "hist" and e.get("name") == name
    ]


def mean_work_imbalance_from_events(
    events: Iterable[Dict[str, Any]], name: str = WORK_IMB
) -> float:
    """Mean of the distributed driver's recorded per-iteration imbalance.

    On the same run this equals ``DistributedResult.mean_imbalance()``
    up to the order of the sum — both are the arithmetic mean of the same
    ``work_imb`` values (asserted in ``tests/test_torch_telemetry_drivers.py``).
    """
    vals = [
        float(e["value"])
        for e in events
        if e.get("kind") == "gauge" and e.get("name") == name
    ]
    if not vals:
        return 0.0
    return sum(vals) / len(vals)
