"""Per-axis VEGAS importance grid: piecewise-linear map + damped refinement.

The port of the JAX package's ``repro.mc.grid``.  The grid factorises the
importance density as a product of per-axis 1-D densities, each held as
``n_bins`` equal-probability bins over the unit interval: bin ``b`` of axis
``i`` maps the uniform slice ``[b/nb, (b+1)/nb)`` onto ``[edges[i, b],
edges[i, b+1])``, so narrow bins concentrate samples and the map's Jacobian
``nb * (edges[b+1] - edges[b])`` is the importance weight the estimator
divides by.

The grid is a fixed ``(d, n_bins + 1)`` array of edges in ``[0, 1]``;
refinement moves the edges, never their count.  Every function also takes a
leading batch axis (the service pool's slots): ``edges (..., d, nb + 1)``,
``dsum (..., d, nb)``, with every reduction over the last axis.
"""

from __future__ import annotations

import torch


def uniform_edges(d: int, n_bins: int, dtype=torch.float64, *, device) -> torch.Tensor:
    """The identity grid: ``(d, n_bins + 1)`` edges ``b * (1 / n_bins)``,
    the last exactly 1 (the reference's ``linspace`` rounds so)."""
    e = torch.arange(n_bins + 1, dtype=dtype, device=device) * (1.0 / n_bins)
    e[-1] = 1.0
    return e.expand(d, n_bins + 1).contiguous()


def bin_index(scaled: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``y * n_bins`` -> owning bin (int64), truncated toward zero and
    clipped to ``[0, n_bins)`` as the reference's ``astype(int32)``."""
    return torch.clamp(scaled.long(), 0, n_bins - 1)


def apply_map(edges: torch.Tensor, y: torch.Tensor):
    """Map uniform ``y`` (d, N) through the grid ``edges`` (d, nb + 1).

    Returns ``(x01, jac)``: the mapped coordinates (d, N) in the unit cube
    and the Jacobian ``prod_i nb * w_bin_i`` (N,), multiplied left to right
    over the axes.  Batched form: ``edges (d, P, nb + 1)`` with ``y (d, P,
    N)`` (the engine passes a transposed view of its ``(P, d, nb + 1)``
    grids), ``jac (P, N)``.
    """
    nb = edges.shape[-1] - 1
    scaled = y * nb
    b = bin_index(scaled, nb)
    frac = scaled - b
    left = torch.gather(edges, -1, b)
    w = torch.gather(edges, -1, b + 1) - left
    x01 = left + frac * w
    nbw = nb * w
    jac = nbw[0]
    for k in range(1, nbw.shape[0]):
        jac = jac * nbw[k]
    return x01, jac


def refine(edges: torch.Tensor, dsum: torch.Tensor, alpha: float) -> torch.Tensor:
    """One damped refinement step from accumulated per-bin weights.

    ``dsum`` (..., d, n_bins) is the iteration's importance measure per bin
    (the engine's per-bin sums of ``(f * jac)^2``).  Per axis: smooth over
    neighbours, normalise, compress with Lepage's damping ``r = ((1 - m) /
    ln(1/m))^alpha``, then rebuild the edges so that every new bin holds
    equal compressed mass.  An axis with no (or non-finite) accumulated
    mass keeps its edges.
    """
    dtype = edges.dtype
    nb = edges.shape[-1] - 1
    dsum = dsum.to(dtype)
    # neighbour smoothing: (d_{i-1} + 6 d_i + d_{i+1}) / 8, reflective ends
    left = torch.cat([dsum[..., :1], dsum[..., :-1]], dim=-1)
    right = torch.cat([dsum[..., 1:], dsum[..., -1:]], dim=-1)
    sm = (left + 6.0 * dsum + right) / 8.0

    total = torch.sum(sm, dim=-1, keepdim=True)
    m = sm / torch.where(total > 0.0, total, torch.ones_like(total))
    # damping: m -> ((1 - m) / ln(1/m))^alpha, continuous limits 0 and 1
    mc = torch.clamp(m, 1e-99, 1.0 - 1e-15)
    r = ((1.0 - mc) / -torch.log(mc)) ** alpha
    # strictly positive floor: a zero-mass bin keeps a nonzero width, else
    # its samples would map to a zero-measure slab (jac = 0) and silently
    # drop that slab from the integral
    r = torch.maximum(r, 1e-10 * torch.amax(r, dim=-1, keepdim=True))

    # rebuild: new edge j sits where the cumulative compressed mass crosses
    # j / nb of the axis total (piecewise-linear inverse CDF over old bins)
    zeros = torch.zeros_like(r[..., :1])
    cr = torch.cat([zeros, torch.cumsum(r, dim=-1)], dim=-1)  # (..., d, nb + 1)
    targets = cr[..., -1:] * (torch.arange(1, nb, dtype=dtype, device=edges.device) / nb)
    k = torch.clamp(torch.searchsorted(cr, targets.contiguous(), right=True) - 1, 0, nb - 1)
    rk = torch.gather(r, -1, k)
    frac = (targets - torch.gather(cr, -1, k)) / rk
    lo = torch.gather(edges, -1, k)
    wi = torch.gather(edges, -1, k + 1) - lo
    interior = lo + torch.clamp(frac, 0.0, 1.0) * wi
    new_edges = torch.cat([zeros, interior, torch.ones_like(zeros)], dim=-1)
    # zero-mass axes (integrand identically zero there so far): keep edges
    keep = (total <= 0.0) | ~torch.isfinite(total)
    return torch.where(keep, edges, new_edges)
