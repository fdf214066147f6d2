"""Event sinks: where Recorder events go.

The port's own copy of the JAX package's ``repro.telemetry.sinks``, with
one difference: the JSON encoder refuses a ``torch.Tensor``.  Encoding one
would read it from its device behind the driver's back, so every value a
driver records must already be a host number.

- :class:`JsonlSink` — one JSON object per line, append-only; the
  ``--metrics PATH`` CLI flag attaches one of these.
- :class:`MemorySink` — in-memory ring buffer; tests and the ``--trace``
  export path use it (Chrome trace export needs the whole event stream).
- :func:`summary_table` — end-of-run plain-text aggregate table rendered
  from a Recorder's in-memory aggregates (``--telemetry-summary``).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional

import torch


class _Encoder(json.JSONEncoder):
    """Python and numpy scalars and arrays; a ``torch.Tensor`` raises."""

    def default(self, o: Any) -> Any:
        if isinstance(o, torch.Tensor):
            raise TypeError(
                f"a torch.Tensor ({tuple(o.shape)}, {o.device}) reached a telemetry "
                "sink: record host numbers, never a tensor (encoding it would read "
                "the device)"
            )
        item = getattr(o, "item", None)
        if item is not None and getattr(o, "shape", None) in ((), None):
            return item()
        tolist = getattr(o, "tolist", None)
        if tolist is not None:
            return tolist()
        return repr(o)


def dumps(obj: Any) -> str:
    """``json.dumps`` with the sinks' encoder."""
    return json.dumps(obj, cls=_Encoder)


class JsonlSink:
    """Append events to ``path`` as JSON Lines."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "w", encoding="utf-8")

    def emit(self, event: Dict[str, Any]) -> None:
        self._fh.write(dumps(event) + "\n")

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL metrics file back into a list of event dicts."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


class MemorySink:
    """Keep the last ``maxlen`` events in memory (``None`` = unbounded)."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self.events: deque = deque(maxlen=maxlen)

    def emit(self, event: Dict[str, Any]) -> None:
        # Copy: the recorder reuses nothing, but callers may mutate attrs
        # dicts they passed in after the fact.
        self.events.append(dict(event))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


def summary_table(recorder: Any) -> str:
    """Render the recorder's aggregates as an aligned plain-text table."""
    lines: List[str] = []

    def section(title: str, rows: List[List[str]], header: List[str]) -> None:
        if not rows:
            return
        widths = [
            max(len(h), *(len(r[i]) for r in rows)) for i, h in enumerate(header)
        ]
        lines.append(title)
        lines.append("  " + "  ".join(h.ljust(w) for h, w in zip(header, widths)))
        for r in rows:
            lines.append("  " + "  ".join(c.ljust(w) for c, w in zip(r, widths)))
        lines.append("")

    section(
        "counters",
        [[k, f"{v:g}"] for k, v in sorted(recorder.counters.items())],
        ["name", "total"],
    )
    section(
        "gauges (last)",
        [[k, f"{v:g}"] for k, v in sorted(recorder.gauges.items())],
        ["name", "value"],
    )
    section(
        "histograms",
        [
            [
                k,
                f"{int(h['count'])}",
                f"{h['sum'] / max(h['count'], 1):.4g}",
                f"{h['min']:.4g}",
                f"{recorder.quantile(k, 0.5):.4g}",
                f"{recorder.quantile(k, 0.99):.4g}",
                f"{h['max']:.4g}",
            ]
            for k, h in sorted(recorder.hists.items())
        ],
        ["name", "count", "mean", "min", "p50", "p99", "max"],
    )
    section(
        "spans",
        [
            [
                k,
                f"{int(t['count'])}",
                f"{t['total_s']:.4f}",
                f"{1e3 * t['total_s'] / max(t['count'], 1):.3f}",
            ]
            for k, t in sorted(recorder.span_totals.items())
        ],
        ["name", "count", "total_s", "mean_ms"],
    )
    if not lines:
        return "(no telemetry recorded)"
    return "\n".join(lines).rstrip()
