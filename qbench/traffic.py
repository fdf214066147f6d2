"""The one generator of the benchmark's traffic, driven by a traffic file.

Every driver takes its problems from :func:`problems`.  A problem is the
configuration's family and dimension, a theta and a tolerance:

- A traffic file without ``theta`` sends the configuration's own problem,
  its theta and ``rel_tol``, again and again: the seed does not change it.
- A traffic file with ``theta``, a range ``[lo, hi]`` per theta field, sends
  a pool of ``pool`` problems drawn once with ``pool_seed``: per problem,
  each ranged field uniform in its range on every axis, in the file's
  order; the fields it does not range keep the configuration's values.
  Problem j has the tolerance ``rel_tol[j % len(rel_tol)]`` of the file, or
  the configuration's.  The stream runs through the pool round after round,
  each round in an order drawn from the run's seed.  So every seed sends
  the same problems, in another order.

The warm-up of set-up (:func:`warmup_problems`) is the pool's first
``warmup`` problems (at least one), whatever the seed.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, List

import numpy as np


def pool(traffic: dict, config: dict) -> List[dict]:
    """The problems a stream draws from (the same for every seed)."""
    q = config["quadrature"]
    base = dict(family=config["family"], d=q["d"], theta=copy.deepcopy(config["theta"]),
                rel_tol=q["rel_tol"])
    ranges = traffic.get("theta")
    if not ranges:
        return [base]
    rng = np.random.default_rng(traffic["pool_seed"])
    tols = traffic.get("rel_tol", [q["rel_tol"]])
    out = []
    for j in range(traffic["pool"]):
        theta = dict(base["theta"] or {})
        for key, (lo, hi) in ranges.items():
            theta[key] = rng.uniform(lo, hi, q["d"]).tolist()
        out.append(dict(base, theta=theta, rel_tol=tols[j % len(tols)]))
    return out


def order(n: int, seed: int) -> Iterator[int]:
    """Indices into a pool of ``n``, round after round, each round in an
    order drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        yield from (int(j) for j in rng.permutation(n))


def problems(traffic: dict, config: dict, seed: int) -> Iterator[dict]:
    """The endless stream of a run's problems."""
    drawn = pool(traffic, config)
    for j in order(len(drawn), seed):
        yield drawn[j]


def warmup_problems(traffic: dict, config: dict) -> List[dict]:
    return pool(traffic, config)[:max(1, traffic.get("warmup", 1))]


def quadrature_fields(config: dict, traffic: dict) -> Dict:
    """The port's configuration fields: the configuration's, then the
    traffic file's (the entry's own settings, such as ``sync_every``)."""
    return {**config["quadrature"], **traffic.get("quadrature", {})}
