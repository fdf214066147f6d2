"""The device trace of a ``--trace 1`` run, reduced to what the metrics read.

:class:`DeviceTrace` runs ``torch.profiler`` over the window and aligns the
profiler's clock with the host's monotonic clock by one marker.  After the
window it keeps, per device, the intervals of every operation that ran
there (kernels, copies, sets), clipped to the window.  The reductions
(:func:`union_s`, :func:`idle_gaps`) are plain functions of intervals, so
the tests drive them on synthetic timelines.

The idle share is one minus the union of a device's intervals over the
window, per device: a sum of kernel times would count overlapping streams
twice and mix the devices of a four-card run.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as disjoint, sorted intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def union_s(intervals: Iterable[Interval]) -> float:
    """Seconds covered by at least one interval."""
    return sum(b - a for a, b in merge(intervals))


def idle_gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type, cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def host_span_at(spans: Sequence[Tuple[float, float, int, str]], t: float) -> str:
    """The innermost host span (start, end, depth, name) around time t."""
    best, depth = "outside host spans", -1
    for a, b, dep, name in spans:
        if a <= t <= b and dep > depth:
            best, depth = name, dep
    return best


def recorder_spans(events) -> List[Tuple[float, float, int, str]]:
    """(start, end, depth, name) of the spans in a recorder's event stream."""
    return [(e["ts"] - e["dur"], e["ts"], e.get("depth", 0), e["name"])
            for e in events if e.get("kind") == "span_end"]


class DeviceTrace:
    """``torch.profiler`` over a window, on the host's monotonic clock.

    Use as a context manager around the window, call :meth:`close_window`
    with the window's monotonic bounds inside it, and read :attr:`ops`
    (per device, a list of (name, start, end) in host seconds) after it.
    """

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._mark: Optional[float] = None
        self.window: Optional[Interval] = None
        self.ops: Dict[int, List[Tuple[str, float, float]]] = {}

    def __enter__(self):
        self._prof.__enter__()
        t0 = time.monotonic()
        with self._torch.profiler.record_function("qbench.align"):
            t1 = time.monotonic()
        self._mark = 0.5 * (t0 + t1)
        return self

    def close_window(self, t0: float, t1: float) -> None:
        self.window = (t0, t1)

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == "qbench.align")
        offset = mark.start_ns() / 1e9 - self._mark  # profiler seconds minus host seconds
        lo, hi = self.window
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue  # a named range shown on the device, not an operation
            a, b = e.start_ns() / 1e9 - offset, e.end_ns() / 1e9 - offset
            if b <= lo or a >= hi:
                continue
            self.ops.setdefault(e.device_index(), []).append((e.name(), max(a, lo), min(b, hi)))
        return False


def summarize(ops: Dict[int, List[Tuple[str, float, float]]], window: Interval,
              devices: Sequence[int], host_spans=()) -> dict:
    """Per device: its operations over the window and their union (busy
    seconds); over the run: the operations that took most time, and the
    idle seconds by what the host was doing."""
    lo, hi = window
    per_device, totals, idle_by_span = {}, {}, {}
    for dev in devices:
        evs = ops.get(dev, [])
        per_device[dev] = dict(busy_s=union_s((a, b) for _, a, b in evs), ops=evs)
        for n, a, b in evs:
            totals[n] = totals.get(n, 0.0) + (b - a)
        for a, b in idle_gaps([(a, b) for _, a, b in evs], lo, hi):
            name = host_span_at(host_spans, 0.5 * (a + b))
            idle_by_span[name] = idle_by_span.get(name, 0.0) + (b - a)
    return dict(
        window_s=hi - lo,
        devices=per_device,
        device_ops=[(short_name(n), s) for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=sorted(idle_by_span.items(), key=lambda kv: -kv[1])[:10],
    )
