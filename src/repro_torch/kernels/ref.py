"""Plain PyTorch version of the fused GM kernel, with the kernel's signature.

Built on :func:`repro_torch.core.genz_malik.gm_eval_reference`, which visits
the nodes and adds the sums in the kernel's order.  The CPU path runs it;
on the card it is only the yardstick the kernel is held against.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.genz_malik import gm_eval_reference


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
