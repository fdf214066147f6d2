"""The telemetry and Pallas-only flags that the port's CLIs share.

``--trace PATH`` (a Chrome trace of the run), ``--metrics PATH`` (the
event stream as JSON Lines) and ``--telemetry-summary`` (the end-of-run
table) mean what they mean in the JAX package's CLIs.  ``--use-kernel`` and
``--interpret`` select the JAX package's Pallas path and its interpret
mode; the port has no such choice (the device picks the path: the CUDA
kernels on a CUDA device, their plain versions on the CPU), so they are
refused with a message instead of being ignored.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch.telemetry.core import NULL, Recorder
from repro_torch.telemetry.sinks import JsonlSink, MemorySink, summary_table
from repro_torch.telemetry.trace import write_chrome_trace


def add_telemetry_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome trace-event file of the run (load it in ui.perfetto.dev): "
        "one lane per rank, spans, counters, flow arrows for migrations and reroutes",
    )
    ap.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="stream telemetry events to PATH as JSON Lines",
    )
    ap.add_argument(
        "--telemetry-summary", action="store_true",
        help="print the end-of-run counter/span summary table",
    )


def add_pallas_flags(ap: argparse.ArgumentParser) -> None:
    """The JAX CLIs' Pallas flags, accepted so that :func:`refuse_pallas_flags`
    can say why they do not apply."""
    ap.add_argument("--use-kernel", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument(
        "--interpret", action=argparse.BooleanOptionalAction, default=None,
        help=argparse.SUPPRESS,
    )


def refuse_pallas_flags(ap: argparse.ArgumentParser, args) -> None:
    for flag, given in (("--use-kernel", args.use_kernel or None), ("--interpret", args.interpret)):
        if given is not None:
            ap.error(
                f"{flag} selects the JAX package's Pallas path, which is out of scope "
                "in the port: the device picks the path (the CUDA kernels on a CUDA "
                "device, their plain versions with --device cpu)"
            )


class CliTelemetry:
    """The recorder that the telemetry flags ask for (``NULL`` when none is
    given), and the files it writes when the run ends."""

    def __init__(self, args) -> None:
        self.args = args
        self.trace_sink: Optional[MemorySink] = None
        self.recorder = NULL
        if args.trace or args.metrics or args.telemetry_summary:
            sinks = []
            if args.trace:
                self.trace_sink = MemorySink()
                sinks.append(self.trace_sink)
            if args.metrics:
                sinks.append(JsonlSink(args.metrics))
            self.recorder = Recorder(sinks=tuple(sinks))

    def finish(self, say: Callable[[str], None]) -> None:
        """Close the sinks, write the trace, and report through ``say``."""
        if self.recorder is NULL:
            return
        self.recorder.close()
        if self.args.trace:
            write_chrome_trace(self.args.trace, self.trace_sink.events)
            say(f"wrote Chrome trace: {self.args.trace}")
        if self.args.metrics:
            say(f"wrote metrics JSONL: {self.args.metrics}")
        if self.args.telemetry_summary:
            say(summary_table(self.recorder))
