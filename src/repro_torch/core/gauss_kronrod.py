"""Tensor-product (G7, K15) Gauss-Kronrod rule (paper §3, low dimension).

The 15-point Kronrod extension of the 7-point Gauss rule is tensorised over
``d`` axes.  The Gauss nodes are a subset of the Kronrod nodes, so the whole
embedded family is evaluated in one streaming pass over the 15^d grid: a
Python loop over chunks of ``chunk`` nodes, each decoded from a flat index,
so that nothing of size 15^d is ever materialised.  Cost grows as 15^d,
which is why the paper limits this rule to low and moderate dimension.

The JAX package has no Pallas kernel for this rule (it is plain XLA, a
``lax.fori_loop`` over the chunks), so the port is torch operations, on the
CPU and on the card alike.

Error estimate: |K - G| over the full tensor grid.  Axis selection: the axis
``i`` maximising |K - G_i|, where G_i applies the Gauss weights along axis i
and the Kronrod weights along the others.
"""

from __future__ import annotations

import numpy as np
import torch

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


def gk_eval_batch(f, centers: torch.Tensor, halfw: torch.Tensor, chunk: int = 512):
    """Evaluate the tensor GK rule on a batch of regions.

    Args:
      f: integrand mapping (d, N) -> (N,).
      centers, halfw: (B, d).
      chunk: nodes processed per streaming step.

    Returns:
      (i_k, i_g, axis_disc): Kronrod and Gauss estimates (B,), plus the
      per-axis |K - G_i| discrepancies (B, d) used for axis selection.
    """
    dtype, device = centers.dtype, centers.device
    b, d = centers.shape
    total = N_1D**d
    n_chunks = -(-total // chunk)

    xk = torch.as_tensor(XK, dtype=dtype, device=device)
    wk = torch.as_tensor(WK, dtype=dtype, device=device)
    wg = torch.as_tensor(WG, dtype=dtype, device=device)
    lane = torch.arange(chunk, device=device)

    ct = centers.T  # (d, B)
    ht = halfw.T

    s_k = torch.zeros(b, dtype=dtype, device=device)
    s_g = torch.zeros(b, dtype=dtype, device=device)
    s_gi = torch.zeros((b, d), dtype=dtype, device=device)
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

        nodes = xk[digits]  # (d, chunk)
        wk_ax = wk[digits]
        wg_ax = wg[digits]
        w_k = torch.prod(wk_ax, dim=0) * valid  # (chunk,)
        w_g = torch.prod(wg_ax, dim=0) * valid
        # per axis: Gauss along axis i, Kronrod elsewhere
        ratio = wg_ax / wk_ax  # (d, chunk); wk is never zero
        w_gi = w_k[None, :] * ratio  # (d, chunk)

        x = ct[:, :, None] + ht[:, :, None] * nodes[:, None, :]  # (d, B, chunk)
        vals = f(x.reshape(d, b * chunk)).reshape(b, chunk)

        s_k = s_k + vals @ w_k
        s_g = s_g + vals @ w_g
        s_gi = s_gi + torch.einsum("bc,dc->bd", vals, w_gi)

    scale = torch.prod(ht, dim=0)  # (B,)
    i_k = scale * s_k
    i_g = scale * s_g
    axis_disc = torch.abs(scale[:, None] * (s_gi - s_k[:, None]))
    return i_k, i_g, axis_disc
