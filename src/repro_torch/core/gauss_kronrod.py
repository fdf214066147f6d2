"""Tensor-product (G7, K15) Gauss-Kronrod rule (paper §3, low dimension).

The 15-point Kronrod extension of the 7-point Gauss rule is tensorised over
``d`` axes.  The Gauss nodes are a subset of the Kronrod nodes, so the whole
embedded family is evaluated in one streaming pass over the 15^d grid: a
Python loop over chunks of ``chunk`` nodes, each decoded from a flat index,
so that nothing of size 15^d is ever materialised, inside a loop over
blocks of regions that bounds the transient.  Cost grows as 15^d, which is
why the paper limits this rule to low and moderate dimension.

The JAX package has no Pallas kernel for this rule (it is plain XLA, a
``lax.fori_loop`` over the chunks), so the port is torch operations, on the
CPU and on the card alike.

Error estimate: |K - G| over the full tensor grid.  Axis selection: the axis
``i`` maximising |K - G_i|, where G_i applies the Gauss weights along axis i
and the Kronrod weights along the others.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.genz_malik import row_prod
from repro_torch.core.region_store import tree_sum

# QUADPACK 15-point Kronrod nodes/weights on [-1, 1]; Gauss-7 is embedded at
# the odd positions.  Symmetric: the full 15 are stored for simple indexing.
_XK_HALF = np.array(
    [
        0.991455371120813,
        0.949107912342759,
        0.864864423359769,
        0.741531185599394,
        0.586087235467691,
        0.405845151377397,
        0.207784955007898,
        0.0,
    ]
)
_WK_HALF = np.array(
    [
        0.022935322010529,
        0.063092092629979,
        0.104790010322250,
        0.140653259715525,
        0.169004726639267,
        0.190350578064785,
        0.204432940075298,
        0.209482141084728,
    ]
)
_WG_HALF = np.array(  # Gauss-7 weights at Kronrod positions 1,3,5,7 (0-based)
    [
        0.0,
        0.129484966168870,
        0.0,
        0.279705391489277,
        0.0,
        0.381830050505119,
        0.0,
        0.417959183673469,
    ]
)

XK = np.concatenate([-_XK_HALF[:-1], _XK_HALF[::-1]])  # 15 ascending nodes
WK = np.concatenate([_WK_HALF[:-1], _WK_HALF[::-1]])
WG = np.concatenate([_WG_HALF[:-1], _WG_HALF[::-1]])

N_1D = 15


def n_nodes(d: int) -> int:
    return N_1D**d


# Regions per evaluation block.  On the CPU a block's integrand calls stay
# under ATen's parallel grain (32768 elements), so that each runs on one
# thread: split points inside an elementwise call would put a few elements
# in the scalar tail of a vector loop, whose exp and pow round differently
# from the vector path, and a region's bits would then depend on where it
# sits in the batch.  On the card every element runs the same code
# wherever it sits, and the block only bounds the transient: ~4 arrays of
# d x block x chunk values (x, the integrand's temporaries, the per-axis
# products), under ~1.1 GB in float64.
CPU_BLOCK_LANES = 1 << 14
DEVICE_BLOCK_ELEMS = 1 << 25


def region_block(device: torch.device, d: int, chunk: int) -> int:
    """Regions evaluated together in one block on ``device``."""
    if device.type == "cpu":
        return max(1, CPU_BLOCK_LANES // chunk)
    return max(1, DEVICE_BLOCK_ELEMS // (d * chunk))


def transient_bytes(d: int, rows: int, item: int, chunk: int = 512) -> int:
    """Device bytes that one :func:`gk_eval_batch` call over ``rows``
    regions holds at once on the card, beyond its inputs and outputs: the
    coordinates and the integrand's temporaries (about three arrays of
    d x block x chunk), the per-axis products and their pairwise sums (about
    one more), and the values."""
    n = min(rows, region_block(torch.device("cuda"), d, chunk))
    return (4 * d + 2) * n * chunk * item


def gk_eval_batch(
    f,
    centers: torch.Tensor,
    halfw: torch.Tensor,
    chunk: int = 512,
    theta_cols: Optional[torch.Tensor] = None,
    theta_fields: Optional[tuple] = None,
):
    """Evaluate the tensor GK rule on a batch of regions.

    Args:
      f: integrand mapping (d, N) -> (N,); with ``theta_cols``, a family's
        ``f(x, theta)``.
      centers, halfw: (B, d).
      chunk: nodes processed per streaming step.  It fixes the order of
        the node sum, so it is never changed to save memory: the region
        axis is split instead (:func:`region_block`).
      theta_cols: None, or ``(n_theta, S)`` with S dividing B: regions
        ``[s B/S, (s+1) B/S)`` take column ``s``, split into the leaves of
        ``theta_fields`` (the batch service's one evaluation over every
        live slot).  Each leaf reaches ``f`` as ``(d, R, 1)`` against
        ``(d, R, chunk)`` coordinates.

    Returns:
      (i_k, i_g, axis_disc): Kronrod and Gauss estimates (B,), plus the
      per-axis |K - G_i| discrepancies (B, d) used for axis selection.

    Every sum over a chunk's nodes is a pairwise sum in a fixed order
    (:func:`repro_torch.core.region_store.tree_sum`), and the chunks add up
    left to right, so a region's bits do not depend on B, on its position
    or on its neighbours' thetas: the batch service gets the bits of
    :func:`repro_torch.core.adaptive.integrate` for every slot.
    """
    dtype, device = centers.dtype, centers.device
    b, d = centers.shape
    total = N_1D**d
    n_chunks = -(-total // chunk)
    if theta_cols is not None:
        n_cols = theta_cols.shape[1]
        if n_cols < 1 or b % n_cols:
            raise ValueError(f"theta_cols has {n_cols} columns, which must divide B={b}")
        lanes_per_col = b // n_cols
        sizes = [theta_cols.shape[0] // len(theta_fields)] * len(theta_fields)

    xk = torch.as_tensor(XK, dtype=dtype, device=device)
    wk = torch.as_tensor(WK, dtype=dtype, device=device)
    wg = torch.as_tensor(WG, dtype=dtype, device=device)
    lane = torch.arange(chunk, device=device)

    # the nodes and weights of every chunk (shared by all regions)
    weights = []
    for c_idx in range(n_chunks):
        flat = c_idx * chunk + lane  # (chunk,)
        valid = (flat < total).to(dtype)
        flat = torch.clamp(flat, max=total - 1)
        # decode base-15 digits: digit[i] for axis i
        digits = []
        rem = flat
        for _ in range(d):
            digits.append(rem % N_1D)
            rem = rem // N_1D
        digits = torch.stack(digits, dim=0)  # (d, chunk)
        wk_ax = wk[digits]
        wg_ax = wg[digits]
        w_k = row_prod(wk_ax) * valid  # (chunk,)
        w_g = row_prod(wg_ax) * valid
        # per axis: Gauss along axis i, Kronrod elsewhere
        ratio = wg_ax / wk_ax  # (d, chunk); wk is never zero
        weights.append((xk[digits], w_k, w_g, w_k[None, :] * ratio))

    ct = centers.T  # (d, B)
    ht = halfw.T
    s_k = torch.empty(b, dtype=dtype, device=device)
    s_g = torch.empty(b, dtype=dtype, device=device)
    s_gi = torch.empty((b, d), dtype=dtype, device=device)
    step = region_block(device, d, chunk)
    for r0 in range(0, b, step):
        blk = slice(r0, min(r0 + step, b))
        n = blk.stop - blk.start
        theta = None
        if theta_cols is not None:
            cols = torch.arange(blk.start, blk.stop, device=device) // lanes_per_col
            rows = theta_cols[:, cols]  # (n_theta, n): one theta per region
            theta = {k: v[:, :, None] for k, v in zip(theta_fields, rows.split(sizes))}
        acc_k = acc_g = acc_gi = None
        for nodes, w_k, w_g, w_gi in weights:
            x = ct[:, blk, None] + ht[:, blk, None] * nodes[:, None, :]  # (d, n, chunk)
            if theta is None:
                vals = f(x.reshape(d, n * chunk)).reshape(n, chunk)
            else:
                vals = f(x, theta)
            part = (
                tree_sum(vals * w_k),
                tree_sum(vals * w_g),
                tree_sum(vals[:, None, :] * w_gi),  # (n, d)
            )
            if acc_k is None:
                acc_k, acc_g, acc_gi = part
            else:
                acc_k, acc_g, acc_gi = acc_k + part[0], acc_g + part[1], acc_gi + part[2]
        s_k[blk], s_g[blk], s_gi[blk] = acc_k, acc_g, acc_gi

    scale = row_prod(ht)  # (B,)
    i_k = scale * s_k
    i_g = scale * s_g
    axis_disc = torch.abs(scale[:, None] * (s_gi - s_k[:, None]))
    return i_k, i_g, axis_disc
