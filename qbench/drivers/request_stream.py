"""Requests through the batch service, pulled as its slots free.

The stream is :func:`qbench.traffic.problems`: endless, so the service
holds as many requests in flight as it has slots.  Set-up serves the
traffic's warm-up fleet and drains it.  The window pulls requests for its
seconds; then the stream ends and the service finishes what it holds.  A
request's latency runs from its pull to its result.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

from qbench import traffic as gen, window


def p95(values: List[float]) -> float:
    """The 95th percentile, nearest rank: the smallest value with at least
    95 % of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(config: dict, traffic: dict, seed: int, seconds: float, devices: list,
        trace: bool) -> window.Outcome:
    import numpy as np

    from repro_torch.core.config import QuadratureConfig
    from repro_torch.service import BatchScheduler, QuadRequest

    cfg = QuadratureConfig(**gen.quadrature_fields(config, traffic), integrand=config["family"])
    rec, sink = window.recorder(trace)
    sched = BatchScheduler(cfg, config["family"], devices=devices, recorder=rec)

    def request(i, p):
        return QuadRequest(req_id=i, theta={k: np.asarray(v) for k, v in p["theta"].items()},
                           rel_tol=p["rel_tol"])

    # set-up: the same warm-up fleet in every run, drained
    warm = gen.warmup_problems(traffic, config)
    for _ in sched.serve([request(i, p) for i, p in enumerate(warm)]):
        pass
    window.sync(devices)
    eng = sched.engine
    reads0, waits0 = eng.host_reads, eng.landed_waits
    problems = gen.problems(traffic, config, seed)
    pulled: Dict[int, tuple] = {}  # req_id -> (pull time, problem)
    finished = []
    window.reset_peaks(devices)
    with window.device_trace(trace) as tr:
        t0 = time.monotonic()

        def stream():
            for i, p in enumerate(problems):
                now = time.monotonic()
                if now - t0 >= seconds:
                    return
                pulled[i] = (now, p)
                yield request(i, p)

        for res in sched.serve(stream()):
            finished.append((res, time.monotonic()))
        window.sync(devices)
        t_end = time.monotonic()
        tr.close_window(t0, t_end)
    peak = window.peak(devices)
    items, lat, in_window = [], [], 0
    for res, t in finished:  # finishing order: the window's come first
        t_pull, p = pulled[res.req_id]
        items.append(dict(p, status=res.status, integral=res.integral, error=res.error,
                          iterations=res.iterations, n_evals=res.n_evals))
        if t - t0 <= seconds:
            in_window += 1
            lat.append(t - t_pull)
    converged = sum(i["status"] == "converged" for i in items[:in_window])
    e2e = {}
    if converged:
        e2e["requests_per_s"] = converged / seconds
    if lat:
        e2e["request_p95_s"] = p95(lat)
    counters = dict(fleet_iterations=sched.last_stats["iterations"],
                    host_reads=eng.host_reads - reads0, landed_waits=eng.landed_waits - waits0)
    return window.Outcome(t0, items, in_window, seconds, e2e, counters, peak,
                          window.trace_summary(tr, devices, sink))
