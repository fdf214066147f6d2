"""AdamW + warmup-cosine schedule + global-norm clipping: the port of
:mod:`repro.training.optimizer`.

Parameters, gradients and moments are dicts keyed by the model's parameter
names (``dict(model.named_parameters())``).  The update runs in place, one
parameter at a time, so a full-width model needs no second copy of its
weights or moments.  It is written out rather than taken from
``torch.optim.AdamW``: a weight with no gradient (``None``) is updated as
if its gradient were zero, so weight decay still reaches it, as the
reference's zero cotangent does.

- **ZeRO-1** (``zero1``): inside a mesh context
  (:func:`repro_torch.distributed.sharding.mesh_rules`) each moment is
  laid out over the data-parallel axes on its first dim that divides them
  (the ``zero1`` rule), as the reference constrains it; the in-place update
  then keeps that layout.  With no mesh the constraint is the identity, as
  in the reference.
- **bf16 gradient compression with error feedback** (``bf16_ef``):
  gradients are rounded to bf16 before the update and the rounding residual
  is carried to the next step.

The step count lives on the host (a 0-d int32 CPU tensor): the schedule and
the bias corrections are float32 functions of it computed there, as the
reference computes them in float32 (its cosine is C's ``cosf``, which is
what XLA's CPU backend calls), so the learning rate has the reference's
bits on every device and reading it never waits for the card.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.distributed.sharding import current_ctx, shard

f32 = np.float32

# the named range around an update, for torch.profiler (lm_perf.py splits a
# training step's device time by it); a few microseconds of host time when
# no profiler runs
OPTIMIZER_RANGE = "lm.optimizer"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    zero1: bool = False
    grad_compression: str = "none"  # none | bf16_ef


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate after ``step`` updates (an int or a 0-d tensor):
    linear warmup, then a cosine down to ``min_lr_frac``; a 0-d float32
    CPU tensor, every operation in float32 as the reference's."""
    step = f32(int(step))
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    frac = (step - f32(cfg.warmup_steps)) / f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    frac = min(max(frac, f32(0.0)), f32(1.0))
    cos = f32(_cosf()(float(f32(np.pi) * frac)))
    cos = f32(cfg.min_lr_frac) + f32((1 - cfg.min_lr_frac) * 0.5) * (f32(1.0) + cos)
    return torch.tensor(f32(cfg.lr) * warm * cos, dtype=torch.float32)


def _zero1_constrain(leaf):
    """Shard the first divisible dim of an optimizer moment over DP axes."""
    ctx = current_ctx()
    if ctx is None or leaf.ndim == 0:
        return leaf
    size = ctx.axis_size(tuple(a for a in ctx.rules.get("zero1") or () if a in ctx.sizes))
    if size <= 1:
        return leaf
    for i, dim in enumerate(leaf.shape):
        if dim % size == 0 and dim >= size:
            names = [None] * leaf.ndim
            names[i] = "zero1"
            return shard(leaf, *names)
    return leaf


def init_opt_state(cfg: OptimizerConfig, params: dict) -> dict:
    """``{"mu", "nu", ["ef"], "count"}``: zero moments (and residuals) per
    parameter name, laid out as each parameter (with ``zero1``, inside a
    mesh context: over the data-parallel axes); ``count`` 0 on the host."""
    state = {
        "mu": {n: torch.zeros_like(p) for n, p in params.items()},
        "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32),
    }
    if cfg.grad_compression == "bf16_ef":
        state["ef"] = {n: torch.zeros_like(p) for n, p in params.items()}
    if cfg.zero1:
        for key in ("mu", "nu"):
            state[key] = {n: _zero1_constrain(m) for n, m in state[key].items()}
    return state


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over the gradients (``None`` skipped) of their
    float32 squares' sums, leaf by leaf."""
    total = None
    for g in grads:
        if g is not None:
            s = g.float().square().sum()
            total = s if total is None else total + s
    if total is None:
        raise ValueError("global_norm of no gradients")
    return torch.sqrt(total)


def _compress(grads: dict, ef: dict) -> tuple[dict, dict]:
    """Add the residual, round to bf16, keep the new residual."""
    out, new_ef = {}, {}
    for n, e in ef.items():
        g = grads.get(n)
        with_ef = e if g is None else g.float() + e
        out[n] = with_ef.to(torch.bfloat16).float()
        new_ef[n] = with_ef - out[n]
    return out, new_ef


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: dict, grads: dict, state: dict):
    """One AdamW step, in place on ``params`` and ``state``.

    ``grads`` maps a parameter name to its gradient (any float dtype; it is
    taken in float32) or to ``None``, or leaves the name out: that weight is
    updated with a zero gradient.  Returns ``(params, state, metrics)``,
    the same dicts, with ``metrics`` ``{"grad_norm", "lr"}``.
    """
    with torch.profiler.record_function(OPTIMIZER_RANGE):
        return _apply(cfg, params, grads, state)


def _apply(cfg: OptimizerConfig, params: dict, grads: dict, state: dict):
    count = state["count"] + 1
    lr = schedule(cfg, count)
    if cfg.grad_compression == "bf16_ef":
        grads, state["ef"] = _compress(grads, state["ef"])
    gnorm = global_norm(grads.get(n) for n in params)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)

    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(int(count)))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(int(count)))
    lr_f = float(lr)  # a float32 value, exact as a Python float
    for n, p in params.items():
        m, v = state["mu"][n], state["nu"][n]
        g = grads.get(n)
        g = torch.zeros_like(p) if g is None else g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        step = (m / b1c).div_(denom).add_(p * cfg.weight_decay)
        del denom
        p.sub_(step.mul_(lr_f))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
