"""Stratified sample generation + VEGAS+ counts-per-hypercube adaptation.

The port of the JAX package's ``repro.mc.stratified``.  The unit cube of
*uniform* coordinates (the ``y``-space the importance grid maps to ``x``)
is divided into ``n_strat^d`` congruent hypercubes.  Each iteration draws a
fixed total of ``n_samples`` points, but the per-cube counts adapt: cubes
whose importance-weighted integrand still has high variance receive more
of the budget (Lepage 2020's damped ``sigma^(2 beta)`` rule).

Dynamic per-cube counts become a *cube-major* assignment: sample ``i``
belongs to the cube whose cumulative count interval contains ``i``, so
adaptation changes values, never shapes, and every cube's samples are one
contiguous run of global indices.  Counts are integers allocated by
cumulative rounding, which conserves the total exactly and keeps every
cube at the ``n_min`` floor.

The uniforms are an argument here: the engine draws them
(:mod:`repro_torch.mc.engine`), so that tests can feed both packages the
same numbers.  Every function takes a leading batch axis (the service
pool's slots) on ``weights`` / ``counts``.
"""

from __future__ import annotations

import torch


def choose_n_strat(d: int, n_samples: int, n_min: int) -> int:
    """Stratifications per axis: the largest ``n`` whose ``n^d`` hypercubes
    still leave every cube ``2 * n_min`` samples (half the budget stays
    free for adaptive reallocation).  Always >= 1; in high dimension it is
    1 and stratification degrades to pure importance sampling."""
    n = 1
    while (n + 1) ** d * 2 * n_min <= n_samples:
        n += 1
    return n


def cube_digits(cube: torch.Tensor, n_strat: int, d: int) -> torch.Tensor:
    """Cube ids (..., N) -> per-axis stratification indices (d, ..., N),
    base ``n_strat`` with axis 0 varying fastest."""
    powers = n_strat ** torch.arange(d, dtype=cube.dtype, device=cube.device)
    powers = powers.reshape((d,) + (1,) * cube.ndim)
    return torch.div(cube[None], powers, rounding_mode="floor") % n_strat


def allocate_counts(weights: torch.Tensor, n_samples: int, n_min: int) -> torch.Tensor:
    """Integer per-cube counts (int64): ``n_min`` each + the rest ∝ ``weights``.

    Cumulative rounding (half to even, as ``jnp.round``) distributes the
    ``n_samples - n_min * M`` spare samples: monotone in the cumulative
    weight, summing to the spare exactly (the last cumulative entry is
    forced), never negative.  All-zero weights fall back to uniform.
    """
    m = weights.shape[-1]
    spare = n_samples - n_min * m
    total = torch.sum(weights, dim=-1, keepdim=True)
    pos = total > 0.0
    w = torch.where(pos, weights / torch.where(pos, total, torch.ones_like(total)), 1.0 / m)
    cum = torch.round(torch.cumsum(w, dim=-1) * spare).long()
    cum[..., -1] = spare
    extra = torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[..., :1]))
    return n_min + torch.clamp(extra, min=0)


def sample_y(u: torch.Tensor, cum: torch.Tensor, index: torch.Tensor, n_strat: int, d: int):
    """Stratified uniform coordinates for the samples at ``index``.

    ``u`` (d, ..., Ns) are uniforms in [0, 1); ``cum`` (..., M) the
    cumulative per-cube counts; ``index`` (..., Ns) *global* sample indices
    in ``[0, n_samples)``, so the cube assignment is a function of the
    global index alone, never of how samples are divided into shards or
    ranks.  Returns ``(y, cube)``: coordinates (d, ..., Ns) uniform within
    each sample's cube, and the owning cube ids (..., Ns).
    """
    cube = torch.searchsorted(cum, index, right=True)
    digits = cube_digits(cube, n_strat, d).to(u.dtype)
    # keep y strictly inside the cube so that bin_index never rounds across
    # a stratification boundary
    u = torch.clamp(u, 0.0, 1.0 - torch.finfo(u.dtype).eps)
    return (digits + u) / n_strat, cube


def adapt_weights(old: torch.Tensor, var_per_cube: torch.Tensor, beta: float) -> torch.Tensor:
    """Damped VEGAS+ count weights: ``sigma_k^(2 beta)``, normalised and
    averaged 50/50 with the previous weights."""
    w = torch.clamp(var_per_cube, min=0.0) ** beta
    total = torch.sum(w, dim=-1, keepdim=True)
    m = w.shape[-1]
    pos = total > 0.0
    w = torch.where(pos, w / torch.where(pos, total, torch.ones_like(total)), 1.0 / m)
    return 0.5 * old + 0.5 * w
