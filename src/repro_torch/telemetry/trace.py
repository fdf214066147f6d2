"""Chrome trace-event export (chrome://tracing / https://ui.perfetto.dev).

The port's own copy of the JAX package's ``repro.telemetry.trace``.  Maps a
recorded event stream (see :mod:`repro_torch.telemetry.core` for the
schema) onto the Trace Event Format:

- one *thread lane* per rank (named ``device <rank>``, as the JAX package
  names its mesh devices) plus a ``scheduler`` lane (lane ``None``);
- ``span_begin``/``span_end`` → ``B``/``E`` duration events (compile,
  dispatch, admit, collect, checkpoint, ...);
- ``instant`` → ``i`` events;
- ``gauge``/``counter`` → ``C`` counter tracks (per-device gauges get one
  track per lane, e.g. the ``service.n_live`` occupancy timelines);
- ``flow_begin``/``flow_end`` → a pair of 1 µs ``X`` slices joined by
  ``s``/``f`` flow arrows — slot migrations and reroutes draw as arrows
  from the source device lane to the destination lane.

Timestamps are converted to microseconds relative to the first event so
traces start at t=0 regardless of the monotonic-clock epoch.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from repro_torch.telemetry.sinks import dumps

PID = 1
SCHEDULER_TID = 0


def _tid(lane: Optional[int]) -> int:
    return SCHEDULER_TID if lane is None else int(lane) + 1


def _attrs(event: Dict[str, Any]) -> Dict[str, Any]:
    skip = {"kind", "name", "ts", "seq", "lane", "depth", "dur", "id"}
    return {k: v for k, v in event.items() if k not in skip}


def to_chrome(
    events: Iterable[Dict[str, Any]], process_name: str = "repro-quad"
) -> Dict[str, Any]:
    """Build a Trace Event Format dict from a recorded event stream."""
    evs = sorted(events, key=lambda e: (e.get("ts", 0.0), e.get("seq", 0)))
    t0 = evs[0]["ts"] if evs else 0.0
    out: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "pid": PID,
            "tid": SCHEDULER_TID,
            "name": "process_name",
            "args": {"name": process_name},
        }
    ]
    lanes = {None}
    for e in evs:
        lanes.add(e.get("lane"))
    for lane in sorted(lanes, key=lambda x: -1 if x is None else int(x)):
        out.append(
            {
                "ph": "M",
                "pid": PID,
                "tid": _tid(lane),
                "name": "thread_name",
                "args": {
                    "name": "scheduler" if lane is None else f"device {lane}"
                },
            }
        )

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 3)

    for e in evs:
        kind = e["kind"]
        name = e["name"]
        ts = us(e["ts"])
        tid = _tid(e.get("lane"))
        if kind == "span_begin":
            out.append(
                {
                    "ph": "B",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "name": name,
                    "cat": name.split(".", 1)[0],
                    "args": _attrs(e),
                }
            )
        elif kind == "span_end":
            out.append(
                {
                    "ph": "E",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "name": name,
                    "cat": name.split(".", 1)[0],
                    "args": _attrs(e),
                }
            )
        elif kind == "instant":
            out.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "name": name,
                    "cat": name.split(".", 1)[0],
                    "args": _attrs(e),
                }
            )
        elif kind == "gauge":
            track = name if e.get("lane") is None else f"{name}[{e['lane']}]"
            out.append(
                {
                    "ph": "C",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "name": track,
                    "args": {"value": e["value"]},
                }
            )
        elif kind == "counter":
            out.append(
                {
                    "ph": "C",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "name": name,
                    "args": {"total": e["total"]},
                }
            )
        elif kind == "flow_begin":
            # A visible anchor slice on the source lane plus the flow start.
            out.append(
                {
                    "ph": "X",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "dur": 1,
                    "name": name,
                    "cat": "flow",
                    "args": _attrs(e),
                }
            )
            out.append(
                {
                    "ph": "s",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts,
                    "id": e["id"],
                    "name": name,
                    "cat": "flow",
                }
            )
        elif kind == "flow_end":
            # Offset the destination anchor 1 µs so the arrow has extent
            # even when both halves were recorded at the same host instant.
            out.append(
                {
                    "ph": "X",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts + 1,
                    "dur": 1,
                    "name": name,
                    "cat": "flow",
                    "args": _attrs(e),
                }
            )
            out.append(
                {
                    "ph": "f",
                    "bp": "e",
                    "pid": PID,
                    "tid": tid,
                    "ts": ts + 1,
                    "id": e["id"],
                    "name": name,
                    "cat": "flow",
                }
            )
        # "hist" events carry no natural trace geometry; their aggregates
        # surface in the summary table instead.
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(
    path: str,
    events: Iterable[Dict[str, Any]],
    process_name: str = "repro-quad",
) -> Dict[str, Any]:
    """Serialize :func:`to_chrome` of ``events`` to ``path``; returns it."""
    doc = to_chrome(events, process_name=process_name)
    text = dumps(doc)  # before opening: a refused attribute leaves no file
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)
    return doc
