"""Quadrature-rule layer: the Genz-Malik and Gauss-Kronrod rules, each with
its error estimate and split-axis choice.

The GM rule has two routes, chosen by the integrand's type alone
(``GenzMalikRule.route``).  An integrand of the registry or a family (it
carries a ``kernel_id``) takes the ``"kernel"`` route, through
``kernels/ops.py``: the hand-written CUDA GM kernel on the card, its plain
version on the CPU.  A torch callable ``f((d, N)) -> (N,)`` takes the
``"torch"`` route: :func:`repro_torch.core.genz_malik.gm_eval_reference`,
torch operations on whatever device the regions are on, the counterpart of
the JAX package's GM evaluation outside its Pallas kernel
(``use_kernel=False``).  Nothing moves from one route to the other on a
failure.  The GK rule is torch operations on every device (the JAX package
has no Pallas kernel for it), so it takes any torch callable.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import gauss_kronrod, genz_malik
from repro_torch.core.config import QuadratureConfig
from repro_torch.core.error import two_level_error
from repro_torch.core.genz_malik import gm_eval_reference, row_prod
from repro_torch.core.integrands import get as get_integrand, parse_spec
from repro_torch.core.region_store import to_device
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


# Elements of one integrand call's coordinates on the torch route.
# gm_eval_reference evaluates a node group one node at a time (as the
# JAX reference's fori_loop does), so a call holds a (d, block) array and
# the integrand's few temporaries of that size: 268 MB each in float64.  A
# group is never one array (the corners alone would be 2^d * d values a
# region, 852 KB at d = 13).
BLOCK_ELEMS = 1 << 25


def region_block(d: int) -> int:
    """Regions per block of the torch route, on every device (a batch of
    fewer regions, as every CPU run of the tests is, is one call)."""
    return max(1, BLOCK_ELEMS // d)


class GenzMalikRule:
    """Degree-7 GM rule + two-level error + fourth-difference axis choice.

    ``integrand`` is a registry entry, a family (then ``theta`` holds its
    coefficients), or a torch callable ``f(x)`` on any device.  ``route``
    says which: ``"kernel"`` for an integrand with a ``kernel_id``,
    ``"torch"`` for a callable.
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
        self.route = "torch" if getattr(integrand, "kernel_id", None) is None else "kernel"
        if self.route == "torch" and theta is not None:
            raise ValueError(
                "a theta needs a family of repro_torch.core.integrands.PARAM_REGISTRY; "
                "a callable takes none (bind it into the callable)"
            )
        self._theta_on = {}  # (device, dtype) -> theta as tensors there

    def _theta(self, like: torch.Tensor):
        """Theta's leaves as tensors on ``like``'s device, copied once and
        through pinned memory: a copy from pageable host memory makes the
        host wait for the device."""
        if self.theta is None:
            return None
        key = (like.device, like.dtype)
        if key not in self._theta_on:
            self._theta_on[key] = {
                k: to_device(v, like.dtype, like.device) for k, v in self.theta.items()
            }
        return self._theta_on[key]

    def eval_batch(
        self,
        centers: torch.Tensor,
        halfw: torch.Tensor,
        theta_cols: Optional[torch.Tensor] = None,
    ):
        """(B, d) regions -> (est, err, split_axis) each of shape (B,).

        ``theta_cols`` (``(n_theta, S)``, S dividing B) gives each run of
        ``B // S`` regions its own theta column in place of the rule's theta:
        the batch service's one evaluation over every live slot.
        """
        if self.route == "torch":
            if theta_cols is not None:
                raise ValueError("a callable takes no theta_cols")
            i7, i5, i3, diffs = self._eval_torch(centers, halfw)
        else:
            i7, i5, i3, diffs = kernel_ops.genz_malik_eval(
                self.integrand,
                centers,
                halfw,
                theta=None if theta_cols is not None else self._theta(centers),
                block_regions=self.block_regions,
                theta_cols=theta_cols,
            )
        vol = row_prod((2.0 * halfw).movedim(-1, 0))
        maxdiff = torch.amax(diffs, dim=-1)
        err = two_level_error(i7, i5, i3, vol, maxdiff, self.noise_mult)
        axis = _select_axis(diffs, halfw)
        return i7, err, axis

    def _eval_torch(self, centers: torch.Tensor, halfw: torch.Tensor):
        """The torch route: (i7, i5, i3, diffs (B, d)), in blocks of
        :func:`region_block` regions (the bits do not depend on the block)."""
        f = getattr(self.integrand, "fn", self.integrand)
        b = centers.shape[0]
        step = region_block(self.d)
        if step >= b:
            return gm_eval_reference(f, centers, halfw)
        parts = [
            gm_eval_reference(f, centers[r0:r0 + step], halfw[r0:r0 + step])
            for r0 in range(0, b, step)
        ]
        return tuple(torch.cat(p) for p in zip(*parts))


class GaussKronrodRule:
    """Tensor-product (G7, K15); cost 15^d, so low and moderate d only.

    ``integrand`` is ``f(x)``, or a family's ``f(x, theta)`` together with
    its ``theta_fields``: then every :meth:`eval_batch` call takes theta as
    ``theta_cols`` (the batch service's one theta per slot).
    """

    route = "torch"  # torch operations on every device

    def __init__(
        self,
        d: int,
        integrand,
        chunk: int = 512,
        safety: float = 1.0,
        theta_fields: Optional[tuple] = None,
    ):
        if d > 6:
            raise ValueError(
                f"tensor Gauss-Kronrod is prohibitive for d={d} (15^d nodes); "
                "the paper restricts it to low/moderate dimensions"
            )
        self.d = d
        self.f = integrand
        self.chunk = chunk
        self.safety = safety
        self.theta_fields = theta_fields
        self.n_evals_per_region = gauss_kronrod.n_nodes(d)

    def eval_batch(
        self,
        centers: torch.Tensor,
        halfw: torch.Tensor,
        theta_cols: Optional[torch.Tensor] = None,
    ):
        """(B, d) regions -> (est, err, split_axis) each of shape (B,).

        ``theta_cols`` (``(n_theta, S)``, S dividing B) gives each run of
        ``B // S`` regions its own theta column, as for the GM rule; it is
        required exactly when the rule holds a family's ``f(x, theta)``.
        """
        if (theta_cols is None) != (self.theta_fields is None):
            raise ValueError(
                "a family's GK rule takes theta_cols, and a plain integrand's none"
            )
        i_k, i_g, axis_disc = gauss_kronrod.gk_eval_batch(
            self.f, centers, halfw, chunk=self.chunk, theta_cols=theta_cols,
            theta_fields=self.theta_fields,
        )
        err = self.safety * torch.abs(i_k - i_g)
        # round-off floor
        eps = torch.finfo(i_k.dtype).eps
        vol = row_prod((2.0 * halfw).movedim(-1, 0))
        err = torch.maximum(err, 50.0 * eps * (torch.abs(i_k) + vol))
        axis = _select_axis(axis_disc, halfw)
        return i_k, err, axis


def make_rule(cfg: QuadratureConfig, integrand=None, theta=None):
    """Build the configured rule.

    ``integrand`` overrides the config-named integrand: a registry entry, a
    family together with ``theta``, or a torch callable ``f(x)``.  A
    config-named family spec (``"genz_gaussian:5,5:0.3,0.7"``) is parsed
    into (family, theta), so that theta reaches the GM kernel as rows; the
    GK rule binds it into the family's torch function.  A family without a
    theta (the batch service) takes one theta per slot, as ``theta_cols``
    of every ``eval_batch`` call, with either rule.  The integrand's type
    alone picks the GM rule's route (``GenzMalikRule.route``), on every
    device.
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

        elif hasattr(f, "theta_fields"):
            # a family without a theta: one theta per slot at every call
            return GaussKronrodRule(cfg.d, fn, theta_fields=f.theta_fields)
        return GaussKronrodRule(cfg.d, fn)
    return GenzMalikRule(
        cfg.d,
        f,
        noise_mult=cfg.noise_mult,
        block_regions=cfg.block_regions,
        theta=theta,
    )
