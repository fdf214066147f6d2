"""Two-level heuristic error estimator tailored to the embedded GM family.

Compares two levels of embedded differences (Berntsen-Espelid-Genz),

    n1 = |I7 - I5|   (behaves like a degree-5 null rule)
    n2 = |I5 - I3|   (degree-3 level)

and, where the integrand is smooth and resolved on the region (small ratio
``r = n1/n2`` and small fourth differences), extrapolates the estimate
down by ``sqrt(2 r)``.  A round-off noise floor keeps differences at
machine noise from driving refinement.
"""

from __future__ import annotations

import torch

_R_CRIT = 0.125
_SMOOTH_FRAC = 0.05  # fourth differences below 5% of mean |f| => smooth


def two_level_error(
    i7: torch.Tensor,
    i5: torch.Tensor,
    i3: torch.Tensor,
    vol: torch.Tensor,
    max_fourth_diff: torch.Tensor,
    noise_mult: float,
) -> torch.Tensor:
    """Per-region heuristic error estimate.

    Args:
      i7, i5, i3: embedded rule estimates, shape (B,).
      vol: region volumes (B,).
      max_fourth_diff: max over axes of the fourth divided differences (B,),
        on the function-value scale (not volume-scaled).
      noise_mult: multiplier on machine epsilon for the noise floor.
    """
    info = torch.finfo(i7.dtype)
    eps, tiny = info.eps, info.tiny
    n1 = torch.abs(i7 - i5)
    n2 = torch.abs(i5 - i3)

    r = n1 / torch.clamp(n2, min=tiny)
    shrink = torch.clamp(torch.sqrt(2.0 * r), max=1.0)
    f_mean = torch.abs(i7) / torch.clamp(vol, min=tiny)
    smooth = max_fourth_diff <= _SMOOTH_FRAC * f_mean
    asymptotic = (n2 > tiny) & (r < _R_CRIT) & smooth
    err = torch.where(asymptotic, n1 * shrink, n1)

    # Round-off noise floor: differences below eps * local magnitude are
    # numerical noise, not signal; clamp so the classifier finalises them.
    noise = noise_mult * eps * (torch.abs(i7) + vol * f_mean)
    return torch.maximum(err, noise)
