"""Device time charged to the program span that launched it, and idle time
with the next operation already launched.

When the port's recorder opens each span as a profiler range
(``Recorder(ranges=torch.profiler.record_function)``), the spans sit in the
profiler's trace, on its clock, on the host thread that opened them.  Each
device operation carries the correlation id of the runtime call that
launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and that call
is in the same trace with its thread and time.  So:

- :func:`charge` charges each operation to the innermost program range
  open on the launching thread at the launch, to :data:`UNLINKED` when no
  launch carries its id, and to :data:`OUTSIDE` when no range was open;
- :func:`idle_issued` splits each idle gap of a device at the launch of
  the operation that ends it: the part after the launch is a device that
  had work queued and waited (on another card's work, an event, the
  launch's own latency); the part before it is a device waiting for the
  host to issue work.  A gap that no operation ends (the window's end)
  is all host.

Both are plain functions of tuples, so the tests drive them on synthetic
events.  :class:`LaunchTrace` is :class:`qbench.devtrace.DeviceTrace` that
also keeps the tuples, read from the profiler's events on the host's
monotonic clock, and :func:`readings` reduces them to what the metrics
read.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from qbench.devtrace import DeviceTrace, Interval, clip, idle_gaps, merge, union_s

UNLINKED = "unlinked"
OUTSIDE = "outside program spans"

# (device, name, start, end, correlation id) of a device operation
Op = Tuple[int, str, float, float, int]
# (thread, start, end, name) of a range on the host
Range = Tuple[int, float, float, str]
# correlation id -> (thread, time) of the runtime call that launched it
Launches = Dict[int, Tuple[int, float]]


def innermost(ranges: Iterable[Range], queries: Sequence[Tuple[int, float]]) -> List[str]:
    """For each (thread, time) query, the name of the innermost range open
    on that thread at that time (ranges on one thread nest), else
    :data:`OUTSIDE`.  One sweep a thread: O((ranges + queries) log)."""
    by_thread: Dict[int, List[Tuple[float, float, str]]] = {}
    for th, a, b, name in ranges:
        by_thread.setdefault(th, []).append((a, b, name))
    asked: Dict[int, List[Tuple[float, int]]] = {}
    for i, (th, t) in enumerate(queries):
        asked.setdefault(th, []).append((t, i))
    out = [OUTSIDE] * len(queries)
    for th, qs in asked.items():
        # an outer range before the inner ones it holds at one start time
        rs = sorted(by_thread.get(th, []), key=lambda r: (r[0], -r[1]))
        stack: List[Tuple[float, float, str]] = []
        k = 0
        for t, i in sorted(qs):
            while k < len(rs) and rs[k][0] <= t:
                while stack and stack[-1][1] < rs[k][0]:
                    stack.pop()
                stack.append(rs[k])
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                out[i] = stack[-1][2]
    return out


def charge(ops: Sequence[Op], launches: Launches, ranges: Iterable[Range]) -> List[str]:
    """The span each operation is charged to, in the order of ``ops``."""
    linked = [i for i, op in enumerate(ops) if op[4] in launches]
    names = innermost(ranges, [launches[ops[i][4]] for i in linked])
    out = [UNLINKED] * len(ops)
    for i, name in zip(linked, names):
        out[i] = name
    return out


def seconds_by_span(ops: Sequence[Op], spans: Sequence[str]) -> Dict[str, float]:
    """Device seconds by span, summed over operations and devices."""
    out: Dict[str, float] = {}
    for op, name in zip(ops, spans):
        out[name] = out.get(name, 0.0) + (op[3] - op[2])
    return out


def idle_issued(ops: Sequence[Op], launches: Launches, window: Interval
                ) -> Dict[int, Tuple[float, float]]:
    """Per device, (idle seconds, the part of them after the operation that
    ends each gap had been launched), over ``window``.  Where several
    operations start at a gap's end, the earliest launch counts; an
    operation with no launch counts as launched at its start."""
    lo, hi = window
    per_dev: Dict[int, List[Tuple[float, float, Optional[float]]]] = {}
    for dev, _, a, b, corr in ops:
        launch = launches.get(corr)
        per_dev.setdefault(dev, []).append((a, b, None if launch is None else launch[1]))
    out = {}
    for dev, evs in per_dev.items():
        first: Dict[float, float] = {}  # start -> earliest launch of the ops starting there
        for a, _, t in evs:
            t = a if t is None else t
            first[a] = min(t, first.get(a, t))
        idle = issued = 0.0
        for a, b in idle_gaps([(a, b) for a, b, _ in evs], lo, hi):
            idle += b - a
            if b < hi:
                issued += max(0.0, b - max(a, first[b]))
        out[dev] = (idle, issued)
    return out


def readings(ops: Sequence[Op], launches: Launches, ranges: Iterable[Range], window: Interval,
             devices: Sequence[int]) -> dict:
    """What the metrics read: device seconds by span (summed over devices),
    each span's share of the window (the union of its operations on each
    device, in %, the mean over ``devices``), and the idle and issued
    shares (each device's, in %, the mean over ``devices``)."""
    lo, hi = window
    ops = [(d, n, max(a, lo), min(b, hi), c) for d, n, a, b, c in ops if b > lo and a < hi]
    spans = charge(ops, launches, ranges)
    w = hi - lo
    grouped: Dict[Tuple[str, int], List[Interval]] = {}
    for (dev, _, a, b, _), name in zip(ops, spans):
        grouped.setdefault((name, dev), []).append((a, b))
    share: Dict[str, float] = {}
    for (name, dev), intervals in grouped.items():
        if dev in devices:
            share[name] = share.get(name, 0.0) + 100.0 * union_s(intervals) / w / len(devices)
    gaps = idle_issued(ops, launches, window)
    idle = [gaps.get(dev, (w, 0.0)) for dev in devices]
    return dict(
        device_by_span=seconds_by_span(ops, spans),
        share_by_span=share,
        idle_share=sum(100.0 * i / w for i, _ in idle) / len(devices),
        idle_issued_share=sum(100.0 * s / w for _, s in idle) / len(devices),
    )


def is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...), as the profiler names it."""
    return name.startswith("cu")


class LaunchTrace(DeviceTrace):
    """:class:`qbench.devtrace.DeviceTrace` that also keeps, on the host's
    monotonic clock, every device operation with its correlation id
    (:attr:`launched_ops`), the runtime calls' threads and times
    (:attr:`launches`), and the ranges named in ``span_names``
    (:attr:`ranges`)."""

    def __init__(self, span_names: Iterable[str]):
        super().__init__()
        self.span_names = frozenset(span_names)
        self.launched_ops: List[Op] = []
        self.launches: Launches = {}
        self.ranges: List[Range] = []

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == "qbench.align")
        offset = mark.start_ns() / 1e9 - self._mark
        for e in events:
            a, b = e.start_ns() / 1e9 - offset, e.end_ns() / 1e9 - offset
            if e.device_type() == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    self.launched_ops.append((e.device_index(), e.name(), a, b, e.correlation_id()))
            elif e.name() in self.span_names:
                self.ranges.append((e.start_thread_id(), a, b, e.name()))
            elif is_launch(e.name()):
                self.launches[e.correlation_id()] = (e.start_thread_id(), a)
        return False
