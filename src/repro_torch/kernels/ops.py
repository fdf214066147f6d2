"""Public wrapper of the fused GM evaluation: picks the path by device.

``genz_malik_eval`` adapts the region store's AoS ``(B, d)`` layout to the
kernel's SoA ``(d, B)`` layout and packs a family's theta into rows in
``theta_fields`` order, broadcast over the lanes.  CPU tensors go to the
plain version (``kernels/ref.py``); CUDA tensors go to the CUDA kernel
(``kernels/genz_malik_eval.py``), or raise.  Nothing falls back from one to
the other.  There is no padding: the kernel masks its own ragged edge.
"""

from __future__ import annotations

from typing import Callable, Union

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
):
    """Fused GM rule evaluation.  Returns (i7, i5, i3, diffs (B, d)).

    ``integrand`` is a registry entry (it carries a ``kernel_id``), a family
    with its ``theta``, or, on the CPU only, any torch callable ``f(x)``.
    """
    gm_kernel.resolve_block(block_regions)  # same rule on every device
    b = centers.shape[0]
    ct = centers.T.contiguous()
    ht = halfw.T.contiguous()
    theta_rows = None
    if theta is not None:
        leaves = [
            torch.as_tensor(theta[k], dtype=centers.dtype, device=centers.device).reshape(-1)
            for k in integrand.theta_fields
        ]
        rows = torch.cat(leaves)
        theta_rows = rows[:, None].expand(rows.shape[0], b)  # lane stride 0

    if centers.device.type == "cpu":
        fn = getattr(integrand, "fn", integrand)
        if theta is not None:
            sizes = [leaf.shape[0] for leaf in leaves]
            fields = integrand.theta_fields
            family_fn = fn

            def fn(x, rows):
                return family_fn(x, dict(zip(fields, rows.split(sizes))))

        i7, i5, i3, diffs = genz_malik_eval_soa_ref(fn, ct, ht, theta_rows)
    elif centers.device.type == "cuda":
        kernel_id = getattr(integrand, "kernel_id", None)
        if kernel_id is None:
            raise ValueError(
                "the CUDA GM kernel cannot inline a Python callable: use an "
                "integrand of repro_torch.core.integrands.REGISTRY or "
                "PARAM_REGISTRY (they carry a kernel_id), or run on device='cpu'"
            )
        i7, i5, i3, diffs = gm_kernel.genz_malik_eval_soa(
            kernel_id, ct, ht, theta_rows, block_regions=block_regions
        )
    else:
        raise ValueError(f"unsupported device {centers.device}")
    return i7, i5, i3, diffs.T
