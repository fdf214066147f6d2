"""Genz-Malik fully-symmetric embedded cubature rules (eager PyTorch).

The degree-7 Genz-Malik rule on the reference cube ``[-1, 1]^d`` with its
embedded degree-5 and degree-3 members.  Node layout for dimension ``d``:

    group 0: centre                                   1
    group 1: (+-lam2, 0, ..., 0) and perms            2d
    group 2: (+-lam3, 0, ..., 0) and perms            2d
    group 3: (+-lam4, +-lam4, 0, ..., 0) and perms    2d(d-1)
    group 4: (+-lam5, ..., +-lam5)                    2^d

    total n(d) = 1 + 4d + 2d(d-1) + 2^d

:func:`gm_eval_reference` is the plain version of the fused CUDA kernel
(``kernels/csrc/genz_malik_eval.cu``): both visit the nodes and add the
sums in one fixed order, and every reduction over the ``d`` axes is an
explicit left-to-right loop, so the two round alike on any device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

# Reference-cube generator radii (squared values are exact rationals).
LAMBDA2 = float(np.sqrt(9.0 / 70.0))
LAMBDA3 = float(np.sqrt(9.0 / 10.0))
LAMBDA4 = float(np.sqrt(9.0 / 10.0))
LAMBDA5 = float(np.sqrt(9.0 / 19.0))

# Ratio used by the fourth-divided-difference axis heuristic.
FOURTH_DIFF_RATIO = (9.0 / 70.0) / (9.0 / 10.0)  # lam2^2 / lam3^2 == 1/7


def n_nodes(d: int) -> int:
    """Total number of integrand evaluations of the GM rule in dimension d."""
    return 1 + 4 * d + 2 * d * (d - 1) + 2**d


@dataclasses.dataclass(frozen=True)
class GMWeights:
    """Weights of the embedded degree-7/5/3 GM family (volume included).

    Multiplying a weighted node sum by ``prod(halfwidths)`` gives the
    integral over the actual box (the 2^d reference volume is folded in).
    """

    d: int
    # degree-7 rule
    w1: float
    w2: float
    w3: float
    w4: float
    w5: float
    # embedded degree-5 rule (groups 0..3 only)
    e1: float
    e2: float
    e3: float
    e4: float
    # embedded degree-3 rule (centre + lam3 group only)
    t1: float
    t3: float


@functools.lru_cache(maxsize=None)
def gm_weights(d: int) -> GMWeights:
    if d < 1:
        raise ValueError(f"Genz-Malik rule needs d >= 1, got {d}")
    vol = float(2**d)
    w1 = vol * (12824.0 - 9120.0 * d + 400.0 * d * d) / 19683.0
    w2 = vol * 980.0 / 6561.0
    w3 = vol * (1820.0 - 400.0 * d) / 19683.0
    w4 = vol * 200.0 / 19683.0
    w5 = vol * 6859.0 / 19683.0 / (2**d)

    e1 = vol * (729.0 - 950.0 * d + 50.0 * d * d) / 729.0
    e2 = vol * 245.0 / 486.0
    e3 = vol * (265.0 - 100.0 * d) / 1458.0
    e4 = vol * 25.0 / 729.0

    # Degree-3 rule using the centre and the lam3 single-coordinate group:
    #   2 * t3 * lam3^2 = vol / 3  (per-axis second moment)
    t3 = vol / (6.0 * (9.0 / 10.0))
    t1 = vol - 2.0 * d * t3
    return GMWeights(d, w1, w2, w3, w4, w5, e1, e2, e3, e4, t1, t3)


def row_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over the leading axis, strictly left to right.

    ``torch.prod`` picks its reduction tree from the shape and the device;
    a fixed order makes the result independent of both (the kernel
    multiplies in the same order).
    """
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out * x[k]
    return out


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis, strictly left to right (see :func:`row_prod`)."""
    out = x[0]
    for k in range(1, x.shape[0]):
        out = out + x[k]
    return out


def _shifted(centers: torch.Tensor, axis: int, delta: torch.Tensor) -> torch.Tensor:
    """Copy of ``centers`` (d, B) with row ``axis`` moved by ``delta`` (B,)."""
    x = centers.clone()
    x[axis] = centers[axis] + delta
    return x


def _eval_axis_groups(f, centers, halfw):
    """Single-coordinate displacement sums + per-axis fourth differences.

    centers/halfw: (d, B).  Returns (sum2, sum3, f0, fourth_diff) with
    sum2/sum3/f0 of shape (B,) and fourth_diff (d, B).
    """
    d = centers.shape[0]
    f0 = f(centers)
    sum2 = torch.zeros_like(f0)
    sum3 = torch.zeros_like(f0)
    diffs = []
    for i in range(d):
        d2 = LAMBDA2 * halfw[i]
        d3 = LAMBDA3 * halfw[i]
        f2p = f(_shifted(centers, i, d2))
        f2m = f(_shifted(centers, i, -d2))
        f3p = f(_shifted(centers, i, d3))
        f3m = f(_shifted(centers, i, -d3))
        sum2 = sum2 + f2p + f2m
        sum3 = sum3 + f3p + f3m
        diffs.append(
            torch.abs(
                f2p + f2m - 2.0 * f0 - FOURTH_DIFF_RATIO * (f3p + f3m - 2.0 * f0)
            )
        )
    return sum2, sum3, f0, torch.stack(diffs, dim=0)


def _eval_pair_group(f, centers, halfw):
    """Group 3 sum: (+-lam4, +-lam4) over all axis pairs i < j.  (B,)."""
    d = centers.shape[0]
    total = torch.zeros_like(centers[0])
    for i in range(d):
        for j in range(i + 1, d):
            di = LAMBDA4 * halfw[i]
            dj = LAMBDA4 * halfw[j]
            for si, sj in ((di, dj), (di, -dj), (-di, dj), (-di, -dj)):
                x = centers.clone()
                x[i] = centers[i] + si
                x[j] = centers[j] + sj
                total = total + f(x)
    return total


def _eval_corner_group(f, centers, halfw, chunk=1):
    """Group 4 sum over the 2^d corners; bit i of k set = axis i negative.

    ``chunk`` corners go through one call of ``f``; the sum adds them one
    at a time, in the order of k, whatever the chunk.
    """
    d, b = centers.shape
    step = LAMBDA5 * halfw  # (d, B)
    k = torch.arange(2**d, device=centers.device)[:, None]
    bits = (k >> torch.arange(d, device=centers.device)[None, :]) & 1
    signs = (1 - 2 * bits).to(centers.dtype)  # (2^d, d) of +-1
    total = torch.zeros_like(centers[0])
    for k0 in range(0, 2**d, chunk):
        sign = signs[k0:k0 + chunk].T[:, :, None]  # (d, chunk, 1)
        x = centers[:, None, :] + step[:, None, :] * sign
        for v in f(x.reshape(d, -1)).reshape(-1, b):
            total = total + v
    return total


def gm_eval_reference(
    f: Callable[[torch.Tensor], torch.Tensor],
    centers: torch.Tensor,
    halfw: torch.Tensor,
    corner_chunk: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain batched GM evaluation.

    Args:
      f: integrand mapping (d, N) coordinates -> (N,) values.
      centers, halfw: (B, d) region centres / halfwidths.
      corner_chunk: corners evaluated by one call of ``f`` (on N = chunk B
        columns, corner-major); the sum still adds one corner at a time in
        order.  On the card the plain version is bound by its launches,
        most of them the 2^d corners', and a larger chunk cuts them.

    Returns:
      (i7, i5, i3, fourth_diff): degree-7/5/3 estimates (B,) each, already
      scaled by the region volume factor prod(halfw), and the per-axis
      fourth differences (B, d) for axis selection.
    """
    d = centers.shape[1]
    w = gm_weights(d)
    ct = centers.T.contiguous()  # (d, B) SoA layout
    ht = halfw.T.contiguous()

    sum2, sum3, f0, diffs = _eval_axis_groups(f, ct, ht)
    sum4 = _eval_pair_group(f, ct, ht)
    sum5 = _eval_corner_group(f, ct, ht, corner_chunk)

    scale = row_prod(ht)  # (B,)
    i7 = scale * (w.w1 * f0 + w.w2 * sum2 + w.w3 * sum3 + w.w4 * sum4 + w.w5 * sum5)
    i5 = scale * (w.e1 * f0 + w.e2 * sum2 + w.e3 * sum3 + w.e4 * sum4)
    i3 = scale * (w.t1 * f0 + w.t3 * sum3)
    return i7, i5, i3, diffs.T
