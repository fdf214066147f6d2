"""Integrals back to back, one client in a closed loop.

The traffic file names the port's entry (``entries/<entry>.py``) and its
settings; the problems come from :func:`qbench.traffic.problems`.  Set-up
solves the traffic's warm-up problems once; the window then solves one problem
after another until its seconds have passed, and ends at the end of the
last integral, its device work included.
"""

from __future__ import annotations

import time

from qbench import files, traffic as gen, window


def _spec(problem: dict) -> str:
    """The port's spec string of a family problem: ``family:a1,..:u1,..``,
    theta fields in the configuration's order, each float by its repr."""
    groups = (",".join(repr(float(x)) for x in v) for v in problem["theta"].values())
    return ":".join([problem["family"], *groups])


def run(config: dict, traffic: dict, seed: int, seconds: float, devices: list,
        trace: bool) -> window.Outcome:
    from repro_torch.core.config import QuadratureConfig
    from repro_torch.telemetry import NULL

    entry = files.load_code("entries", traffic["entry"])
    fields = gen.quadrature_fields(config, traffic)

    def solve(problem, rec):
        cfg = QuadratureConfig(**dict(fields, rel_tol=problem["rel_tol"]),
                               integrand=_spec(problem))
        return entry.solve(cfg, devices, rec)

    for problem in gen.warmup_problems(traffic, config):  # set-up: libraries, allocator, windows
        solve(problem, NULL)
    window.sync(devices)
    rec, sink = window.recorder(trace)
    stream = gen.problems(traffic, config, seed)
    items = []
    window.reset_peaks(devices)
    with window.device_trace(trace) as tr:
        t0 = t1 = time.monotonic()
        while True:
            problem = next(stream)
            with rec.span("qbench.solve", n=len(items)):
                res = solve(problem, rec)
                window.sync(devices)
            t = time.monotonic()
            items.append(dict(problem, status=res.status, integral=res.integral, error=res.error,
                              iterations=res.iterations, n_evals=res.n_evals, wall_s=t - t1,
                              **entry.record(res)))
            t1 = t
            if t1 - t0 >= seconds:
                break
        tr.close_window(t0, t1)
    peak = window.peak(devices)
    converged = sum(i["status"] == "converged" for i in items)
    e2e = {"solve_s": (t1 - t0) / converged} if converged else {}
    return window.Outcome(t0, items, len(items), t1 - t0, e2e, {}, peak,
                          window.trace_summary(tr, devices, sink))
