"""Reductions that the per-layer metrics share.

A metric file under ``metrics/`` calls one of these on the run it is given
(``run.items``: the integrals or requests finished in the window;
``run.all_items``: with those the service finished after it, whose work the
trace also covers; ``run.counters``; ``run.trace``: the device trace's
summary, or ``None``).  A kernel is named by a pattern that the metric's
file declares.  A reader that finds nothing to read returns ``None``, and
the harness leaves the metric out.
"""

from __future__ import annotations

from typing import Optional

from qbench import files
from qbench.devtrace import union_s
from qbench.roofline import gm_work


def mean_of(run, key: str) -> Optional[float]:
    values = [i[key] for i in run.items if i.get(key) is not None]
    return sum(values) / len(values) if values else None


def ratio(run, num: str, den: str) -> Optional[float]:
    """sum(num) / sum(den) over the run's items."""
    d = sum(i[den] for i in run.items)
    return sum(i[num] for i in run.items) / d if d else None


def _traced(run) -> bool:
    t = run.trace
    return bool(t and t["devices"] and t["window_s"] > 0)


def idle_share(run) -> Optional[float]:
    """Per device, 1 - the union of its operations over the window, in %;
    the largest over the run's devices."""
    if not _traced(run):
        return None
    t = run.trace
    return max(100.0 * (1.0 - d["busy_s"] / t["window_s"]) for d in t["devices"].values())


def share_without(run, pattern: str) -> Optional[float]:
    """The union of every device operation whose name lacks ``pattern``,
    over the window, in %, averaged over the run's devices."""
    if not _traced(run):
        return None
    t = run.trace
    shares = [100.0 * union_s((a, b) for n, a, b in d["ops"] if pattern not in n) / t["window_s"]
              for d in t["devices"].values()]
    return sum(shares) / len(shares)


def kernel_s(run, pattern: str) -> float:
    """Device seconds of the operations named by ``pattern``, summed over
    devices."""
    return sum(b - a for d in run.trace["devices"].values() for n, a, b in d["ops"]
               if pattern in n)


def gm_roofline(run, pattern: str) -> Optional[float]:
    """The least time of the evaluations the run needed, over the device
    time of the kernel named by ``pattern`` (summed over devices), in %."""
    if not _traced(run):
        return None
    seconds = kernel_s(run, pattern)
    n_evals = sum(i["n_evals"] for i in run.all_items)
    if seconds <= 0 or n_evals <= 0:
        return None
    q = run.config["quadrature"]
    point_ops = files.load_code("families", run.config["family"]).point_ops(q["d"])
    item = 8 if q.get("dtype", "float64") == "float64" else 4
    return 100.0 * gm_work(point_ops, q["d"], n_evals, item)["least_s"] / seconds
