"""Recorder: the host-side event spine of the port's telemetry.

The port's own copy of the JAX package's ``repro.telemetry.core`` (the port
imports nothing of that package); the event envelope, the names and the
aggregates are the same, so that either package's tools read the other's
event streams.  Everything here is plain Python over plain dicts: no
third-party dependencies, no background threads, no global mutable
registry.  A :class:`Recorder` turns instrumentation calls (``count`` /
``gauge`` / ``observe`` / ``event`` / ``flow`` / ``span``) into *event
dicts* pushed to attached sinks (see :mod:`repro_torch.telemetry.sinks`),
while keeping cheap in-memory aggregates for the end-of-run summary table.

The cardinal rule: **the recorder reads nothing from a device.**  Call
sites live at the host's own decision points: after the stacked read an
iteration already makes, around ``engine.run``, inside the host-side
admission and collection loops.  Every value it records is a host number
the driver holds anyway, so with the recorder on or off the same device
work is queued, the same reads are made, and the results keep their bits
(``tests/test_torch_telemetry_drivers.py``).  A span that ends with no
device read measures the host's enqueue time, not device time.

Disabled telemetry costs one attribute lookup: call sites hold a
``Recorder`` reference (``NULL`` by default) and guard any non-trivial
bookkeeping with ``if rec.enabled:``.  :class:`NullRecorder` methods are
no-ops returning cached singletons, so even unguarded calls are a few
hundred nanoseconds.

Event schema (one dict per event; sinks serialize it verbatim)::

    {"kind": "counter" | "gauge" | "hist" | "instant"
             | "span_begin" | "span_end" | "flow_begin" | "flow_end",
     "name": str,          # dotted taxonomy, e.g. "service.dispatch"
     "ts":   float,        # seconds on the recorder clock (monotonic)
     "seq":  int,          # global order tiebreaker (clock may be coarse)
     "lane": int | None,   # rank index, or None for the scheduler lane
     ...}                  # kind-specific payload (value, attrs, id, dur)

The clock is injectable (``Recorder(clock=fake)``) so tests assert exact
span durations and orderings deterministically.

The port's streams carry the JAX package's names plus the stage spans of
its drivers (``core.init``, ``core.partition``, ``core.rule``,
``core.classify``, ``core.compact``, ``core.split``, ``core.read``,
``core.snapshot``; ``dist.init``, ``dist.eval``, ``dist.exchange``,
``dist.advance``, ``dist.round``, ``dist.snapshot``, ``dist.read``), which
nest inside the JAX package's own spans.  With
``Recorder(ranges=torch.profiler.record_function)`` every span also opens a
profiler range of its name for its duration, so the spans sit in the
profiler's trace, on its clock, around the device work they launch.  This
module stays free of torch: the caller supplies the callable.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, ContextManager, Dict, Iterator, List, Optional, Tuple


#: Per-histogram raw-sample retention cap.  ``observe`` keeps the first N
#: values so :meth:`Recorder.quantile` can answer p50/p99 exactly for runs
#: of realistic length (a dispatch-boundary histogram collects one value
#: per dispatch — tens of thousands at most); past the cap new values still
#: update count/sum/min/max but no longer enter the quantile sample.  The
#: first-N policy is deterministic, which the bit-parity and fake-clock
#: tests rely on.
HIST_SAMPLE_CAP = 16384


def quantile(values: List[float], q: float) -> float:
    """Linear-interpolation quantile of ``values`` (q in [0, 1]).

    Plain Python (no numpy) so offline consumers — the perf report reading
    a metrics JSONL long after the run — share the exact computation the
    live recorder uses.
    """
    if not values:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


class Recorder:
    """Collects structured telemetry events and aggregates.

    Parameters
    ----------
    sinks:
        Iterable of sink objects with an ``emit(event: dict)`` method (and
        optionally ``flush()`` / ``close()``).  See
        :mod:`repro_torch.telemetry.sinks`.
    clock:
        Zero-arg callable returning seconds.  Defaults to
        :func:`time.monotonic`; inject a fake for deterministic tests.
    ranges:
        Optional callable taking a span's name and returning a context
        manager, entered for the span's body (a profiler range, e.g.
        ``torch.profiler.record_function``).  ``None`` opens none.
    """

    enabled = True

    def __init__(
        self,
        sinks: Tuple[Any, ...] = (),
        clock: Callable[[], float] = time.monotonic,
        ranges: Optional[Callable[[str], ContextManager[Any]]] = None,
    ) -> None:
        self.sinks: List[Any] = list(sinks)
        self.clock = clock
        self.ranges = ranges
        self._seq = 0
        self._flow_id = 0
        self._span_depth = 0
        # Aggregates for the summary table / stats compatibility views.
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Dict[str, float]] = {}
        self.hist_samples: Dict[str, List[float]] = {}
        self.span_totals: Dict[str, Dict[str, float]] = {}

    # -- plumbing ---------------------------------------------------------

    def add_sink(self, sink: Any) -> None:
        self.sinks.append(sink)

    def _emit(self, event: Dict[str, Any]) -> None:
        event["seq"] = self._seq
        self._seq += 1
        for sink in self.sinks:
            sink.emit(event)

    def flush(self) -> None:
        for sink in self.sinks:
            fn = getattr(sink, "flush", None)
            if fn is not None:
                fn()

    def close(self) -> None:
        for sink in self.sinks:
            fn = getattr(sink, "close", None)
            if fn is not None:
                fn()

    # -- metrics ----------------------------------------------------------

    def count(
        self, name: str, n: float = 1, lane: Optional[int] = None, **attrs: Any
    ) -> None:
        """Increment counter ``name`` by ``n`` and emit a counter event.

        The event carries the running ``total`` so trace export can draw a
        cumulative counter track without replaying the stream.
        """
        total = self.counters.get(name, 0) + n
        self.counters[name] = total
        # attrs first throughout: a caller attr must never overwrite the
        # envelope ("kind", "ts", ...) — a collision would silently turn the
        # event into an unknown type that every consumer drops
        self._emit(
            {
                **attrs,
                "kind": "counter",
                "name": name,
                "ts": self.clock(),
                "lane": lane,
                "n": n,
                "total": total,
            }
        )

    def gauge(
        self, name: str, value: float, lane: Optional[int] = None, **attrs: Any
    ) -> None:
        """Record the current value of ``name`` (last-write-wins aggregate)."""
        key = name if lane is None else f"{name}[{lane}]"
        self.gauges[key] = value
        self._emit(
            {
                **attrs,
                "kind": "gauge",
                "name": name,
                "ts": self.clock(),
                "lane": lane,
                "value": value,
            }
        )

    def observe(
        self, name: str, value: float, lane: Optional[int] = None, **attrs: Any
    ) -> None:
        """Add ``value`` to histogram ``name`` (count/sum/min/max stats)."""
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = {
                "count": 0,
                "sum": 0.0,
                "min": float("inf"),
                "max": float("-inf"),
            }
        h["count"] += 1
        h["sum"] += value
        h["min"] = min(h["min"], value)
        h["max"] = max(h["max"], value)
        samples = self.hist_samples.setdefault(name, [])
        if len(samples) < HIST_SAMPLE_CAP:
            samples.append(value)
        self._emit(
            {
                **attrs,
                "kind": "hist",
                "name": name,
                "ts": self.clock(),
                "lane": lane,
                "value": value,
            }
        )

    def quantile(self, name: str, q: float) -> float:
        """Quantile of histogram ``name``'s retained samples (0 if empty).

        Exact (linear interpolation over every observed value) until the
        histogram passes :data:`HIST_SAMPLE_CAP` observations, after which
        it is the quantile of the first cap-many values.
        """
        return quantile(self.hist_samples.get(name, []), q)

    def hist_quantiles(
        self, name: str, qs: Tuple[float, ...] = (0.5, 0.99)
    ) -> Dict[float, float]:
        """Several quantiles of histogram ``name`` at once (p50/p99 default)."""
        return {q: self.quantile(name, q) for q in qs}

    def event(
        self, name: str, lane: Optional[int] = None, **attrs: Any
    ) -> None:
        """Emit a point-in-time (instant) event."""
        self._emit(
            {
                **attrs,
                "kind": "instant",
                "name": name,
                "ts": self.clock(),
                "lane": lane,
            }
        )

    # -- spans -------------------------------------------------------------

    @contextmanager
    def span(
        self, name: str, lane: Optional[int] = None, **attrs: Any
    ) -> Iterator[Dict[str, Any]]:
        """Record a nested duration span around the ``with`` body.

        Yields a mutable attrs dict — entries added inside the body ride on
        the ``span_end`` event (e.g. ``sp["executed"] = k`` after a fused
        dispatch returns how many iterations actually ran).  With
        ``ranges`` set, the body runs inside ``ranges(name)``.
        """
        t0 = self.clock()
        depth = self._span_depth
        self._span_depth = depth + 1
        self._emit(
            {
                **attrs,
                "kind": "span_begin",
                "name": name,
                "ts": t0,
                "lane": lane,
                "depth": depth,
            }
        )
        merged: Dict[str, Any] = dict(attrs)
        try:
            if self.ranges is None:
                yield merged
            else:
                with self.ranges(name):
                    yield merged
        finally:
            t1 = self.clock()
            self._span_depth = depth
            tot = self.span_totals.get(name)
            if tot is None:
                tot = self.span_totals[name] = {"count": 0, "total_s": 0.0}
            tot["count"] += 1
            tot["total_s"] += t1 - t0
            self._emit(
                {
                    **merged,
                    "kind": "span_end",
                    "name": name,
                    "ts": t1,
                    "lane": lane,
                    "depth": depth,
                    "dur": t1 - t0,
                }
            )

    # -- flows -------------------------------------------------------------

    def flow(
        self,
        name: str,
        src_lane: Optional[int],
        dst_lane: Optional[int],
        **attrs: Any,
    ) -> int:
        """Record a cross-lane flow (slot migration, reroute) as a
        begin/end pair sharing a fresh flow id; returns that id.

        Trace export turns each pair into a Perfetto flow arrow from the
        source lane to the destination lane.
        """
        self._flow_id += 1
        fid = self._flow_id
        ts = self.clock()
        self._emit(
            {
                **attrs,
                "kind": "flow_begin",
                "name": name,
                "ts": ts,
                "lane": src_lane,
                "id": fid,
            }
        )
        self._emit(
            {
                **attrs,
                "kind": "flow_end",
                "name": name,
                "ts": ts,
                "lane": dst_lane,
                "id": fid,
            }
        )
        return fid


class _NullSpan:
    """Reusable no-op context manager; swallows attr writes."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def __setitem__(self, key: str, value: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """No-op recorder: telemetry off.

    Call sites keep a module- or instance-level reference to :data:`NULL`
    and call it unconditionally; every method returns immediately.  Guard
    anything that *computes* (reshapes, sums, string formatting) with
    ``if rec.enabled:`` so disabled telemetry does no work at all.
    """

    enabled = False
    sinks: Tuple[Any, ...] = ()
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, float]] = {}
    hist_samples: Dict[str, List[float]] = {}
    span_totals: Dict[str, Dict[str, float]] = {}

    def add_sink(self, sink: Any) -> None:  # pragma: no cover - misuse guard
        raise RuntimeError(
            "cannot attach a sink to the NULL recorder; build a Recorder()"
        )

    def count(self, name: str, n: float = 1, lane: Optional[int] = None, **attrs: Any) -> None:
        return None

    def gauge(self, name: str, value: float, lane: Optional[int] = None, **attrs: Any) -> None:
        return None

    def observe(self, name: str, value: float, lane: Optional[int] = None, **attrs: Any) -> None:
        return None

    def quantile(self, name: str, q: float) -> float:
        return 0.0

    def hist_quantiles(
        self, name: str, qs: Tuple[float, ...] = (0.5, 0.99)
    ) -> Dict[float, float]:
        return {q: 0.0 for q in qs}

    def event(self, name: str, lane: Optional[int] = None, **attrs: Any) -> None:
        return None

    def span(self, name: str, lane: Optional[int] = None, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def flow(
        self,
        name: str,
        src_lane: Optional[int],
        dst_lane: Optional[int],
        **attrs: Any,
    ) -> int:
        return 0

    def flush(self) -> None:
        return None

    def close(self) -> None:
        return None


#: Module-level disabled recorder — the default everywhere.
NULL = NullRecorder()
