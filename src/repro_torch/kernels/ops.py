"""Public wrapper of the fused GM evaluation: picks the path by device.

``genz_malik_eval`` adapts the region store's AoS ``(B, d)`` layout to the
kernel's SoA ``(d, B)`` layout.  A family's theta comes in one of two forms:
one problem's theta as a dict, packed into rows in ``theta_fields`` order and
broadcast over the lanes; or ``theta_cols``, one column per run of
``B // S`` lanes (the batch service: one column per slot).  CPU tensors go to
the plain version (``kernels/ref.py``); CUDA tensors go to the CUDA kernel
(``kernels/genz_malik_eval.py``), or raise.  Nothing falls back from one to
the other.  There is no padding: the kernel masks its own ragged edge.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.integrands import Integrand, ParamIntegrand
from repro_torch.kernels import genz_malik_eval as gm_kernel
from repro_torch.kernels.ref import genz_malik_eval_soa_ref


def genz_malik_eval(
    integrand: Union[Integrand, ParamIntegrand, Callable],
    centers: torch.Tensor,  # (B, d) AoS, as stored by RegionState
    halfw: torch.Tensor,  # (B, d)
    theta=None,  # a ParamIntegrand's theta: dict of (d,) leaves
    block_regions: int = 0,
    theta_cols: Optional[torch.Tensor] = None,  # (n_theta, S), S dividing B
):
    """Fused GM rule evaluation.  Returns (i7, i5, i3, diffs (B, d)).

    ``integrand`` is a registry entry (it carries a ``kernel_id``), a family
    with its ``theta`` or ``theta_cols``, or, on the CPU only, any torch
    callable ``f(x)``.  With ``theta_cols``, lanes ``[s * B / S, (s + 1) *
    B / S)`` take column ``s``; no ``(n_theta, B)`` array is made on the
    card.
    """
    gm_kernel.resolve_block(block_regions)  # same rule on every device
    b = centers.shape[0]
    ct = centers.T.contiguous()
    ht = halfw.T.contiguous()
    theta_rows = None
    lanes_per_col = 0
    if theta is not None and theta_cols is not None:
        raise ValueError("pass theta or theta_cols, not both")
    if theta is not None:
        leaves = [
            torch.as_tensor(theta[k], dtype=centers.dtype, device=centers.device).reshape(-1)
            for k in integrand.theta_fields
        ]
        rows = torch.cat(leaves)
        sizes = [leaf.shape[0] for leaf in leaves]
        theta_rows = rows[:, None].expand(rows.shape[0], b)  # lane stride 0
    elif theta_cols is not None:
        n_cols = theta_cols.shape[1]
        if n_cols < 1 or b % n_cols:
            raise ValueError(f"theta_cols has {n_cols} columns, which must divide B={b}")
        lanes_per_col = b // n_cols
        theta_rows = theta_cols
        n_fields = len(integrand.theta_fields)
        sizes = [theta_cols.shape[0] // n_fields] * n_fields

    if centers.device.type == "cpu":
        fn = getattr(integrand, "fn", integrand)
        if theta_rows is not None:
            fields = integrand.theta_fields
            family_fn = fn

            def fn(x, rows):
                return family_fn(x, dict(zip(fields, rows.split(sizes))))

        i7, i5, i3, diffs = genz_malik_eval_soa_ref(fn, ct, ht, theta_rows, lanes_per_col)
    elif centers.device.type == "cuda":
        kernel_id = getattr(integrand, "kernel_id", None)
        if kernel_id is None:
            raise ValueError(
                "the CUDA GM kernel cannot inline a Python callable: use an "
                "integrand of repro_torch.core.integrands.REGISTRY or "
                "PARAM_REGISTRY (they carry a kernel_id), or run on device='cpu'"
            )
        i7, i5, i3, diffs = gm_kernel.genz_malik_eval_soa(
            kernel_id, ct, ht, theta_rows, block_regions=block_regions,
            lanes_per_col=lanes_per_col,
        )
    else:
        raise ValueError(f"unsupported device {centers.device}")
    return i7, i5, i3, diffs.T
