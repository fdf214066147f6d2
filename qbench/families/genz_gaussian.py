"""The Genz Gaussian family: exp(-sum_i a_i^2 (x_i - u_i)^2) over [0, 1]^d.

The paper's f4, exp(-625 sum_i (x_i - 1/2)^2), is its member with every
a_i = 25 and u_i = 1/2.
"""

import math


def exact(d, theta):
    """Per axis: int_0^1 exp(-a^2 (x - u)^2) dx
    = sqrt(pi) / (2a) * (erf(a (1 - u)) + erf(a u))."""
    a, u = [float(x) for x in theta["a"]], [float(x) for x in theta["u"]]
    if len(a) != d or len(u) != d:
        raise ValueError(f"theta of length {len(a)}, {len(u)} for d={d}")
    p = 1.0
    for ai, ui in zip(a, u):
        p *= math.sqrt(math.pi) / (2.0 * ai) * (math.erf(ai * (1.0 - ui)) + math.erf(ai * ui))
    return p


def point_ops(d):
    """FP64 operations of one evaluation: per axis x - u, a * t, t * t and
    the add that folds it; then the negation and the exp."""
    return 4 * d + 2
