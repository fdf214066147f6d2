"""What every driver shares: the outcome of a window, the devices'
synchronise and memory peaks, the recorder and the device trace."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from qbench.devtrace import recorder_spans, summarize


@dataclasses.dataclass
class Outcome:
    """What one run's window produced."""

    t0: float  # the window's start, on the monotonic clock
    items: List[dict]  # every finished integral or request, in finishing order
    in_window: int  # the first in_window items finished inside the window
    window_s: float
    e2e: Dict[str, float]
    counters: Dict[str, float]
    peak_bytes: int
    trace: Optional[dict] = None


def cards(devices) -> List[str]:
    return sorted({str(d) for d in devices if str(d).startswith("cuda")})


def sync(devices) -> None:
    import torch

    for dev in cards(devices):
        torch.cuda.synchronize(dev)


def reset_peaks(devices) -> None:
    import torch

    for dev in cards(devices):
        torch.cuda.reset_peak_memory_stats(dev)


def peak(devices) -> int:
    """The largest ``max_memory_allocated`` over the devices (0 on the CPU)."""
    import torch

    return max((torch.cuda.max_memory_allocated(d) for d in cards(devices)), default=0)


def recorder(trace: bool):
    """The port's recorder for the window, and its sink (None untraced)."""
    from repro_torch.telemetry import NULL, MemorySink, Recorder

    if not trace:
        return NULL, None
    sink = MemorySink()
    return Recorder((sink,)), sink


def device_trace(trace: bool):
    """``torch.profiler`` over the window when traced; else a stand-in."""
    if trace:
        from qbench.devtrace import DeviceTrace

        return DeviceTrace()
    return _NoTrace()


def trace_summary(tr, devices, sink) -> Optional[dict]:
    if sink is None:
        return None
    indices = [int(d.split(":")[1]) for d in cards(devices)]
    return summarize(tr.ops, tr.window, indices, recorder_spans(sink.events))


class _NoTrace:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close_window(self, t0, t1):
        pass
