"""Observability of the port: host-side telemetry for every driver.

The port's own copy of the JAX package's ``repro.telemetry`` (same event
names, envelope and aggregates; the port imports nothing of that package).
Everything is recorded on the host at the drivers' own decision points and
nothing reads a device, so the recorder on or off gives the same bits and
the same host syncs.

- :mod:`~repro_torch.telemetry.core`: :class:`Recorder` (counters, gauges,
  histograms, nestable spans, flows) and the no-op :data:`NULL`;
- :mod:`~repro_torch.telemetry.sinks`: JSONL and in-memory sinks, the
  summary table;
- :mod:`~repro_torch.telemetry.trace`: Chrome trace-event (Perfetto) export;
- :mod:`~repro_torch.telemetry.loadview`: per-rank occupancy, idle fraction
  and Fig. 4b imbalance views of a recorded stream;
- :mod:`~repro_torch.telemetry.stats`: the typed :class:`ServiceStats`;
- :mod:`~repro_torch.telemetry.check`: the artifact checker
  (``python -m repro_torch.telemetry.check``);
- :mod:`~repro_torch.telemetry.logutil`: the CLIs' logging setup.
"""

from repro_torch.telemetry.core import NULL, NullRecorder, Recorder, quantile
from repro_torch.telemetry.sinks import JsonlSink, MemorySink, read_jsonl, summary_table
from repro_torch.telemetry.stats import ServiceStats
from repro_torch.telemetry.trace import to_chrome, write_chrome_trace

__all__ = [
    "NULL",
    "NullRecorder",
    "Recorder",
    "quantile",
    "JsonlSink",
    "MemorySink",
    "read_jsonl",
    "summary_table",
    "ServiceStats",
    "to_chrome",
    "write_chrome_trace",
]
