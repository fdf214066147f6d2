"""Quadrature-rule layer: the Genz-Malik and Gauss-Kronrod rules, each with
its error estimate and split-axis choice.

On a CUDA device the GM rule evaluates through the hand-written GM kernel,
which knows only the integrands of the registry (``kernel_id``); a Python
callable raises there.  On the CPU any torch callable runs through the
plain version.  The GK rule is torch operations on every device (the JAX
package has no Pallas kernel for it), so it takes any torch callable.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import gauss_kronrod, genz_malik
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.error import two_level_error
from repro_torch.core.genz_malik import row_prod
from repro_torch.core.integrands import get as get_integrand, parse_spec
from repro_torch.kernels import ops as kernel_ops


def _select_axis(diffs: torch.Tensor, halfw: torch.Tensor) -> torch.Tensor:
    """argmax fourth-difference; fall back to the widest axis when flat.

    ``torch.argmax`` returns the first of several equal maxima, as
    ``jnp.argmax`` does.
    """
    eps = torch.finfo(diffs.dtype).eps
    best = torch.argmax(diffs, dim=-1).to(torch.int32)
    widest = torch.argmax(halfw, dim=-1).to(torch.int32)
    flat = torch.amax(diffs, dim=-1) <= eps * 100.0
    return torch.where(flat, widest, best)


class GenzMalikRule:
    """Degree-7 GM rule + two-level error + fourth-difference axis choice.

    ``integrand`` is a registry entry, a family (then ``theta`` holds its
    coefficients), or a torch callable ``f(x)`` (CPU only).
    """

    def __init__(
        self,
        d: int,
        integrand,
        noise_mult: float = 50.0,
        block_regions: int = 0,  # 0 = kernels.genz_malik_eval.DEFAULT_BLOCK
        theta=None,
    ):
        self.d = d
        self.integrand = integrand
        self.theta = theta
        self.noise_mult = noise_mult
        self.block_regions = block_regions
        self.n_evals_per_region = genz_malik.n_nodes(d)
        self._theta_on = {}  # (device, dtype) -> theta as tensors there

    def _theta(self, like: torch.Tensor):
        """Theta's leaves as tensors on ``like``'s device, copied once: a
        copy from pageable host memory per evaluate step would make the
        host wait for the device."""
        if self.theta is None:
            return None
        key = (like.device, like.dtype)
        if key not in self._theta_on:
            self._theta_on[key] = {
                k: torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device)
                for k, v in self.theta.items()
            }
        return self._theta_on[key]

    def eval_batch(self, centers: torch.Tensor, halfw: torch.Tensor):
        """(B, d) regions -> (est, err, split_axis) each of shape (B,)."""
        i7, i5, i3, diffs = kernel_ops.genz_malik_eval(
            self.integrand,
            centers,
            halfw,
            theta=self._theta(centers),
            block_regions=self.block_regions,
        )
        vol = row_prod((2.0 * halfw).T)
        maxdiff = torch.amax(diffs, dim=-1)
        err = two_level_error(i7, i5, i3, vol, maxdiff, self.noise_mult)
        axis = _select_axis(diffs, halfw)
        return i7, err, axis


class GaussKronrodRule:
    """Tensor-product (G7, K15); cost 15^d, so low and moderate d only."""

    def __init__(self, d: int, integrand, chunk: int = 512, safety: float = 1.0):
        if d > 6:
            raise ValueError(
                f"tensor Gauss-Kronrod is prohibitive for d={d} (15^d nodes); "
                "the paper restricts it to low/moderate dimensions"
            )
        self.d = d
        self.f = integrand
        self.chunk = chunk
        self.safety = safety
        self.n_evals_per_region = gauss_kronrod.n_nodes(d)

    def eval_batch(self, centers: torch.Tensor, halfw: torch.Tensor):
        """(B, d) regions -> (est, err, split_axis) each of shape (B,)."""
        i_k, i_g, axis_disc = gauss_kronrod.gk_eval_batch(
            self.f, centers, halfw, chunk=self.chunk
        )
        err = self.safety * torch.abs(i_k - i_g)
        # round-off floor
        eps = torch.finfo(i_k.dtype).eps
        vol = torch.prod(2.0 * halfw, dim=-1)
        err = torch.maximum(err, 50.0 * eps * (torch.abs(i_k) + vol))
        axis = _select_axis(axis_disc, halfw)
        return i_k, err, axis


def make_rule(
    cfg: QuadratureConfig,
    integrand=None,
    theta=None,
    device: Optional[torch.device] = None,
):
    """Build the configured rule for ``device``.

    ``integrand`` overrides the config-named integrand: a registry entry, a
    family together with ``theta``, or a torch callable ``f(x)``.  A
    config-named family spec (``"genz_gaussian:5,5:0.3,0.7"``) is parsed
    into (family, theta), so that theta reaches the GM kernel as rows; the
    GK rule binds it into the family's torch function.
    """
    if theta is not None and integrand is None:
        raise ValueError("theta requires an explicit family integrand")
    if cfg.rule not in ("genz_malik", "gauss_kronrod"):
        raise ValueError(f"unknown rule {cfg.rule!r}")
    if integrand is not None:
        f = integrand
    elif ":" in cfg.integrand:
        f, theta = parse_spec(cfg.integrand)
    else:
        f = get_integrand(cfg.integrand)
    if cfg.rule == "gauss_kronrod":
        fn = getattr(f, "fn", f)
        if theta is not None:
            family_fn, bound = fn, theta

            def fn(x):
                return family_fn(x, bound)

        return GaussKronrodRule(cfg.d, fn)
    if device is not None and torch.device(device).type == "cuda":
        if getattr(f, "kernel_id", None) is None:
            raise ValueError(
                "a Python callable cannot run in the CUDA GM kernel, which "
                "inlines only the integrands of "
                "repro_torch.core.integrands.REGISTRY and PARAM_REGISTRY; "
                "use one of those or device='cpu'"
            )
    return GenzMalikRule(
        cfg.d,
        f,
        noise_mult=cfg.noise_mult,
        block_regions=cfg.block_regions,
        theta=theta,
    )
