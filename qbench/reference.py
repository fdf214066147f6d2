"""Plain reference of the benchmark: closed-form integrals over the unit cube.

Each family's exact value is worked out by its file under ``families/``
from the theta that the benchmark made, with the standard library's
``math`` alone; nothing of the program is imported or read.  The
comparison that decides ``correct`` (:func:`judge`) holds what the timed
path produced against these values.
"""

from __future__ import annotations

import math
from typing import Dict

from qbench import files


def exact(family: str, d: int, theta) -> float:
    """The exact integral of ``family`` at ``theta`` over [0, 1]^d, from
    ``families/<family>.py``."""
    return files.load_code("families", family).exact(d, theta)


def judge(answers, limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """The numbers compared, each with its limit.

    ``answers`` are the finished items (integrals or requests), each a dict
    with ``status``, ``integral``, ``exact`` and ``rel_tol``.  Returns
    ``{name: {"value": v, "limit": l}}`` for every name in ``limits``:

    - ``failed_share``: the share of items whose status is not
      ``converged`` (limit 0 where every item has to converge);
    - ``worst_err_over_tol``: the largest true relative error in units of
      the item's own tolerance, over the items that did not end
      ``capacity`` (a store too small for the request is a failure of the
      request, counted in ``failed_share``, not a wrong answer).

    An item with no finite answer reads ``inf``.  No item at all reads 1
    for the share and ``inf`` for the error, so an empty run is never
    correct.
    """
    def rel_err(a):
        if not math.isfinite(a["integral"]):
            return math.inf
        return abs(a["integral"] - a["exact"]) / abs(a["exact"])

    n = len(answers)
    unconverged = sum(a["status"] != "converged" for a in answers)
    kept = [a for a in answers if a["status"] != "capacity"]
    values = {
        "failed_share": unconverged / n if n else 1.0,
        "worst_err_over_tol": max((rel_err(a) / a["rel_tol"] for a in kept), default=math.inf),
    }
    return {k: {"value": values[k], "limit": float(v)} for k, v in limits.items()}


def passes(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit (an exact comparison: limit 0)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
