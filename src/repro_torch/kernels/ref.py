"""Plain PyTorch versions of the fused GM kernel, with the kernel's signature.

:func:`genz_malik_eval_soa_ref` is built on
:func:`repro_torch.core.genz_malik.gm_eval_reference`, which visits the
nodes and adds the sums in the kernel's order.  The CPU path runs it; on the
card it is the yardstick the kernel is held against.

:func:`genz_malik_eval_soa_tables_ref` transcribes the kernel's own
arithmetic: each integrand split into term / fold / finish
(``csrc/integrands.cuh``), the per-axis term tables, and the left-to-right
fold per node (``csrc/gm_kernel.cuh``).  Nothing on the main path calls it;
the CPU tests hold it bit for bit against the plain version, which checks
the decomposition that the CUDA functors mirror without a GPU compiler.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.genz_malik import (
    FOURTH_DIFF_RATIO,
    LAMBDA2,
    LAMBDA3,
    LAMBDA4,
    LAMBDA5,
    gm_eval_reference,
    gm_weights,
)
from repro_torch.core.integrands import _F2_B2, _pow11


def genz_malik_eval_soa_ref(
    f: Callable[..., torch.Tensor],
    centers: torch.Tensor,  # (d, B)
    halfw: torch.Tensor,  # (d, B)
    theta_rows: Optional[torch.Tensor] = None,  # (n_theta, B)
):
    """Returns (i7, i5, i3, diffs (d, B)), as the CUDA kernel does.

    Without ``theta_rows``, ``f`` maps ``(d, N)`` coordinates to ``(N,)``;
    with them, ``f(x, theta_rows)`` is called with the ``(n_theta, B)`` rows.
    """
    fx = f if theta_rows is None else (lambda x: f(x, theta_rows))
    i7, i5, i3, diffs = gm_eval_reference(fx, centers.T, halfw.T)
    return i7, i5, i3, diffs.T


# --- the kernel's term / fold / finish, by kernel id ---------------------------


class Decomposition(NamedTuple):
    """``finish(fold_k term(k, x_k))``; ``th(r)`` is theta row r, ``d`` the dimension."""

    term: Callable  # (k, x_k (B,), th, d) -> (B,)
    fold: Callable  # (acc, t) -> acc
    finish: Callable  # (acc, d) -> (B,)


def _add(acc, t):
    return acc + t


def _mul(acc, t):
    return acc * t


def _keep(p, d):
    return p


def _coeff(k, x):
    """The plain integrands' per-axis coefficient k + 1, in x's dtype."""
    return torch.tensor(k + 1.0, dtype=x.dtype, device=x.device)


def _linear_term(k, x, th, d):  # f1, f3: (k+1) x_k, and x_0 itself on axis 0
    return x if k == 0 else _coeff(k, x) * x


def _f2_term(k, x, th, d):
    t = x - 0.5
    return 1.0 / (_F2_B2 + t * t)


def _f3_finish(s, d):
    base = 1.0 + s
    return torch.pow(base, torch.full_like(base, -(d + 1.0)))


def _f4_term(k, x, th, d):
    t = x - 0.5
    return t * t


def _f6_term(k, x, th, d):
    # outside the box the term is NaN, which the sum carries to finish
    i = _coeff(k, x)
    return torch.where(x <= (3.0 + i) / 10.0, (i + 4.0) * x, math.nan)


def _f6_finish(s, d):
    return torch.where(torch.isnan(s), torch.zeros_like(s), torch.exp(s))


def _gaussian_term(k, x, th, d):
    t = th(k) * (x - th(d + k))
    return t * t


def _product_peak_term(k, x, th, d):
    a = th(k)
    t = x - th(d + k)
    return 1.0 / (1.0 / (a * a) + t * t)


DECOMPOSITIONS: dict[int, Decomposition] = {
    0: Decomposition(_linear_term, _add, lambda s, d: torch.cos(s)),
    1: Decomposition(_f2_term, _mul, _keep),
    2: Decomposition(_linear_term, _add, _f3_finish),
    3: Decomposition(_f4_term, _add, lambda s, d: torch.exp(-(25.0**2) * s)),
    4: Decomposition(lambda k, x, th, d: torch.abs(x - 0.5), _add,
                     lambda s, d: torch.exp(-10.0 * s)),
    5: Decomposition(_f6_term, _add, _f6_finish),
    6: Decomposition(lambda k, x, th, d: x * x, _add, lambda s, d: _pow11(s)),
    7: Decomposition(_gaussian_term, _add, lambda s, d: torch.exp(-s)),
    8: Decomposition(_product_peak_term, _mul, _keep),
    9: Decomposition(lambda k, x, th, d: torch.pow(x, th(k)), _mul, _keep),
}


def genz_malik_eval_soa_tables_ref(
    kernel_id: int,
    centers: torch.Tensor,  # (d, B)
    halfw: torch.Tensor,  # (d, B)
    theta_rows: Optional[torch.Tensor] = None,  # (n_theta, B)
):
    """The kernel's table form in torch.  Returns (i7, i5, i3, diffs (d, B)).

    Per region: the centre's terms C, the lambda2/lambda3 terms inside the
    axis loop, the +-lambda4 tables for the pairs and the +-lambda5 tables
    for the corners (5 d terms in tables); each node folds its d terms left
    to right from axis 0 and finishes once.
    """
    dec = DECOMPOSITIONS[kernel_id]
    d = centers.shape[0]
    w = gm_weights(d)

    def th(r):
        return theta_rows[r]

    def term(k, x):
        return dec.term(k, x, th, d)

    def node(terms):
        acc = terms[0]
        for t in terms[1:]:
            acc = dec.fold(acc, t)
        return dec.finish(acc, d)

    def shifted(lam):
        steps = [lam * halfw[k] for k in range(d)]
        plus = [term(k, centers[k] + steps[k]) for k in range(d)]
        minus = [term(k, centers[k] - steps[k]) for k in range(d)]
        return plus, minus

    C = [term(k, centers[k]) for k in range(d)]
    f0 = node(C)

    sum2 = torch.zeros_like(f0)
    sum3 = torch.zeros_like(f0)
    diffs = []
    for a in range(d):
        d2 = LAMBDA2 * halfw[a]
        d3 = LAMBDA3 * halfw[a]
        f2p, f2m, f3p, f3m = (
            node(C[:a] + [term(a, x)] + C[a + 1:])
            for x in (centers[a] + d2, centers[a] - d2, centers[a] + d3, centers[a] - d3)
        )
        sum2 = sum2 + f2p + f2m
        sum3 = sum3 + f3p + f3m
        diffs.append(
            torch.abs(f2p + f2m - 2.0 * f0 - FOURTH_DIFF_RATIO * (f3p + f3m - 2.0 * f0))
        )

    P, M = shifted(LAMBDA4)
    sum4 = torch.zeros_like(f0)
    for a in range(d):
        for b in range(a + 1, d):
            for ta, tb in ((P[a], P[b]), (P[a], M[b]), (M[a], P[b]), (M[a], M[b])):
                terms = list(C)
                terms[a], terms[b] = ta, tb
                sum4 = sum4 + node(terms)

    P, M = shifted(LAMBDA5)
    sum5 = torch.zeros_like(f0)
    for m in range(2**d):
        sum5 = sum5 + node([M[k] if (m >> k) & 1 else P[k] for k in range(d)])

    scale = halfw[0]
    for k in range(1, d):
        scale = scale * halfw[k]
    i7 = scale * (w.w1 * f0 + w.w2 * sum2 + w.w3 * sum3 + w.w4 * sum4 + w.w5 * sum5)
    i5 = scale * (w.e1 * f0 + w.e2 * sum2 + w.e3 * sum3 + w.e4 * sum4)
    i3 = scale * (w.t1 * f0 + w.t3 * sum3)
    return i7, i5, i3, torch.stack(diffs, dim=0)
