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
    lanes_per_col: int = 0,
    corner_chunk: int = 1,
):
    """Returns (i7, i5, i3, diffs (d, B)), as the CUDA kernel does.

    Without ``theta_rows``, ``f`` maps ``(d, N)`` coordinates to ``(N,)``;
    with them, ``f(x, theta_rows)`` is called with the ``(n_theta, B)`` rows.
    With ``lanes_per_col`` > 0, ``theta_rows`` holds one column per run of
    ``lanes_per_col`` lanes, as the kernel takes it; here each column is
    repeated over its lanes.  ``corner_chunk`` is gm_eval_reference's: the
    theta rows are tiled over a chunk's corners.
    """
    if lanes_per_col:
        theta_rows = theta_rows.repeat_interleave(lanes_per_col, dim=1)
    b = centers.shape[1]

    def fx(x):
        if theta_rows is None:
            return f(x)
        return f(x, theta_rows if x.shape[1] == b else theta_rows.repeat(1, x.shape[1] // b))

    i7, i5, i3, diffs = gm_eval_reference(fx, centers.T, halfw.T, corner_chunk)
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


# --- the redistribution round (csrc/redistribute_round.cu) ---------------------


def _as_counts(counts) -> torch.Tensor:
    return counts if isinstance(counts, torch.Tensor) else torch.stack(list(counts))


def _round_plan(counts, rank: int, shift: int, cap: int, limit: int):
    """Rank ``rank``'s ``(n_send, n_recv)`` from every rank's count ``(n,)``:
    the fair share is ``[total // n, ceil(total / n)]`` and each rank's
    stats ``[n_rows, free, surplus, deficit]``; the rank sends to its
    receiver ``rank + shift`` and receives from its donor ``rank - shift``
    (``redistribution.round_counts`` on host integers)."""
    n = counts.shape[0]
    total = counts.sum()
    fair_lo, fair_hi = total // n, -(-total // n)

    def stats(rows):  # [n_rows, free, surplus, deficit]; n_rows >= 0 already
        return torch.stack([rows, limit - rows, rows - fair_hi, fair_lo - rows]).clamp(min=0)

    own, down, up = (stats(counts[(rank + s) % n]) for s in (0, shift, -shift))
    # n_send = min(cap, surplus, down_free, down_deficit),
    # n_recv = min(cap, up_surplus, free, deficit)
    room = torch.stack([down, own])[:, 1::2].amin(1)
    offer = torch.stack([own, up])[:, 2]
    n_send, n_recv = torch.minimum(offer, room).clamp(max=cap).unbind()
    if counts.device.type == "cpu":
        # what lets the kernel run every rank of a device in one launch
        # without a barrier: a rank never both sends and receives.  Checked
        # in the operation itself (it raises here), not by a host read.
        torch._assert_async(~((n_send > 0) & (n_recv > 0)),
                            f"rank {rank} both sends and receives in one round")
    return n_send, n_recv


def round_ref(counts, ranks, shift: int, cap: int, limit: int, stores, sources):
    """The round kernel's plain version, for the ranks ``ranks`` (ring
    indices) of one device at ring distance ``shift``, in place.

    ``counts`` are every rank's live count (n int64 scalars, or one ``(n,)``
    tensor); ``stores`` each rank's ``(centers, halfw, est, err, axis,
    active, fresh)``; ``sources`` per rank its donor's index in ``stores``
    (the donor's centres and half-widths read at rows ``(count_donor -
    n_recv + j) mod C``), or a staged ``(min(cap, C), 2d)`` block
    (:func:`round_pack_ref`), read at row j.
    The received block goes in after the rank's rows and the sent window is
    retired: both are rows ``base + j``, written at ``(base + j) mod C``,
    distinct positions, so the write is deterministic; a row neither sent
    nor received gets its old value back, and a received row past the store
    is dropped.  Returns each rank's count after the round and the rows it
    sent, int64 scalars viewing one ``(len(ranks), 2)`` tensor.
    """
    counts = _as_counts(counts)
    n = counts.shape[0]
    rows = []
    for r, (centers, halfw, est, err, axis, active, fresh), source in zip(ranks, stores, sources):
        C, d = centers.shape
        n_send, n_recv = _round_plan(counts, r, shift, cap, limit)
        base = counts[r] - n_send
        j = torch.arange(min(cap, C), device=centers.device)
        dest = (base + j) % C
        kept = torch.minimum(n_recv, C - base)
        recv = j < kept
        if isinstance(source, torch.Tensor):
            incoming = source
        else:  # the donor sends the n_recv rows at the tail of its count
            src = (counts[(r - shift) % n] - n_recv + j) % C
            donor = stores[source]
            incoming = torch.cat([donor[0].index_select(0, src), donor[1].index_select(0, src)], 1)
        coords = torch.cat([centers.index_select(0, dest), halfw.index_select(0, dest)], 1)
        new = torch.where(recv[:, None], incoming, coords)
        centers.index_copy_(0, dest, new[:, :d])
        halfw.index_copy_(0, dest, new[:, d:])
        for t in (est, err, axis):
            t.index_copy_(0, dest, t.index_select(0, dest).masked_fill(recv, 0))
        keep = ~(j < n_send)
        for t in (active, fresh):
            t.index_copy_(0, dest, t.index_select(0, dest) & keep | recv)
        rows.append(torch.stack([base + kept, n_send]))
    vals = torch.stack(rows).flatten().unbind()
    return list(vals[0::2]), list(vals[1::2])


def round_pack_ref(counts, ranks, shift: int, cap: int, limit: int, stores, blocks) -> None:
    """The pack kernel's plain version: each donor's block ``(min(cap, C),
    2d)``, written in place.  ``stores`` are the donors' ``(centers,
    halfw)``; row j of a block holds the donor's row ``(base + j) mod C``,
    where the reference's clamped positions are, for j below the rows it
    sends, and zeros after."""
    counts = _as_counts(counts)
    for r, (centers, halfw), block in zip(ranks, stores, blocks):
        C = centers.shape[0]
        n_send, _ = _round_plan(counts, r, shift, cap, limit)
        j = torch.arange(min(cap, C), device=centers.device)
        src = (counts[r] - n_send + j) % C
        coords = torch.cat([centers.index_select(0, src), halfw.index_select(0, src)], 1)
        block.copy_(torch.where((j < n_send)[:, None], coords, 0.0))
