"""Loss + train step for every architecture family: the port of
:mod:`repro.training.train`.

The model holds the float32 master weights.  With ``param_gather_dtype``
bf16 (the default) the step keeps a second :class:`Model`, the compute
copy, whose >= 2-D float32 weights are bf16 leaves: it is refreshed from
the master before each step, the loss runs on it, and each weight's
gradient is the gradient with respect to its bf16 copy (bf16, as the
reference's, which differentiates with respect to the cast tree).  The
update then runs on the master.  With float32 the master itself is
differentiated.  Either way the master's weights need no gradient outside
the step, so a served model stays gradient-free.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import (
    BATCH_AXES,
    current_ctx,
    layout_of,
    local,
    replicate_on,
    shard,
    sharded_axes,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import Model, model_forward
from repro_torch.training.optimizer import OptimizerConfig, apply_updates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "none"  # none | full | dots
    microbatches: int = 1  # gradient accumulation steps
    # Cast >= 2-D float32 weights to this dtype before they are consumed
    # (under FSDP the per-layer all-gather then moves bf16); the float32
    # master stays, and the gradients are accumulated in float32.
    param_gather_dtype: str = "bfloat16"
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def batch_to(batch: dict, device) -> dict:
    """A numpy batch (``repro_torch.data``'s) as tensors on ``device``:
    token ids and labels int64, embeddings and the loss mask float32."""
    out = {}
    for key, value in batch.items():
        dtype = torch.long if key in ("tokens", "labels") else torch.float32
        out[key] = torch.as_tensor(np.asarray(value)).to(device=device, dtype=dtype)
    return out


def lm_loss(cfg: ModelConfig, model: Model, batch: dict, remat: str = "none"):
    """Cross-entropy next-token (or per-frame) loss.

    batch keys: "tokens" (B, St) and/or "embeds" (B, Sf, d); "labels"
    (B, S_out) aligned with the model's output positions; optional
    "loss_mask" (B, S_out).  Returns (total, metrics): the masked mean NLL
    over float32 logits, plus ``router_aux_coef`` times the MoE aux loss and
    1e-3 times its z-loss.
    """
    logits, aux = model_forward(
        cfg, model, tokens=batch.get("tokens"), embeds=batch.get("embeds"), remat=remat
    )
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    nll = _nll(logits, labels)
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    metrics = {"ce_loss": loss}
    total = loss
    if "aux_loss" in aux:
        total = total + cfg.router_aux_coef * aux["aux_loss"]
        metrics["router_aux"] = aux["aux_loss"]
        metrics["dropped_frac"] = aux.get("dropped_frac", 0.0)
        total = total + 1e-3 * aux.get("z_loss", 0.0)
    metrics["total_loss"] = total
    return total, metrics


def _nll(logits, labels):
    """Each position's negative log-likelihood of its label (float32)."""
    ctx = current_ctx()
    if ctx is None or layout_of(logits) is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    # vocab-parallel: the log-sum-exp reduces over the vocab shards, and each
    # rank picks the labels that fall in its own slice of the vocab
    from torch.distributed.tensor import Partial

    lg = layout_of(logits)
    v_axes = sharded_axes(lg, ctx, 2)
    v0, _ = ctx.shard_range(lg, 2, logits.shape[2])
    lp = tuple(Partial() if p.is_shard(2) else p for p in lg)  # summed over the vocab shards
    ll = replicate_on(lg, ctx, *v_axes)
    m = logits.detach().amax(dim=-1, keepdim=True)

    def sum_exp(logits, m):
        return (logits - m).exp().sum(dim=-1)

    def pick(logits, labels):
        lab = labels - v0
        inside = (lab >= 0) & (lab < logits.shape[-1])
        got = torch.gather(logits, -1, torch.where(inside, lab, 0)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    lse = local(sum_exp, lp, (lg, ll))(logits, m).log() + shard(m[..., 0], "batch", "seq")
    return shard(lse - local(pick, lp, (lg, ll))(logits, labels), "batch", "seq")


def compute_copy(cfg: ModelConfig, device, dtype: torch.dtype, like: Model | None = None) -> Model:
    """An uninitialised :class:`Model` on ``device`` whose >= 2-D weights
    are ``dtype`` (the 1-D ones float32), every weight a leaf that requires
    grad; built on the meta device first, so no float32 copy is allocated.
    Given the master ``like``, each weight is laid out as its master's (a
    DTensor's shards over its mesh)."""
    copy = Model(cfg, device="meta")
    masters = dict(like.named_parameters()) if like is not None else {}
    for mod_name, mod in copy.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            dt = dtype if p.dim() >= 2 else p.dtype
            master = masters.get(f"{mod_name}.{name}" if mod_name else name)
            if master is not None and layout_of(master) is not None:
                t = torch.empty_like(master, dtype=dt)
            else:
                t = torch.empty(p.shape, dtype=dt, device=device)
            setattr(mod, name, nn.Parameter(t))
    return copy


class TrainStep:
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``,
    updating ``model`` and ``opt_state`` in place (:func:`make_train_step`)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig):
        self.cfg, self.tcfg = cfg, tcfg
        self.gather = DTYPES[tcfg.param_gather_dtype]
        self._copy = None  # the compute copy, built at the first step

    def differentiated(self, model: Model) -> Model:
        """The model the step differentiates: the master itself, or under
        the bf16 cast its compute copy, refreshed from the master."""
        if self.gather == torch.float32:
            return model
        if self._copy is None or self._copy.device != model.device:
            self._copy = compute_copy(self.cfg, model.device, self.gather, like=model)
        with torch.no_grad():
            for c, p in zip(self._copy.parameters(), model.parameters()):
                c.copy_(p)
        return self._copy

    def _grads_of(self, model: Model, batch: dict):
        loss, metrics = lm_loss(self.cfg, model, batch, self.tcfg.remat)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}, grads

    def accumulate(self, model: Model, acc: list, micro: dict) -> dict:
        """Adds one microbatch's gradients into the float32 accumulator
        ``acc`` (one per weight of ``model``); returns its metrics."""
        metrics, chunk = self._grads_of(model, micro)
        for a, g in zip(acc, chunk):
            if g is not None:
                a.add_(g)
        return metrics

    def named_grads(self, model: Model, grads: list) -> dict:
        """``grads`` by weight name; under a mesh context each laid out as
        its weight (a reduce-scatter where the backward left it partial), as
        the reference constrains them."""
        if current_ctx() is not None:
            grads = [
                g if g is None or layout_of(g) is None else g.redistribute(p.device_mesh, p.placements)
                for g, p in zip(grads, model.parameters())
            ]
        return dict(zip((n for n, _ in model.named_parameters()), grads))

    def grads(self, model: Model, batch: dict) -> tuple[dict, dict]:
        """The loss's metrics and each weight's gradient by name (``None``
        for a weight the loss does not reach): bf16 for the >= 2-D weights
        under the bf16 cast with one microbatch, float32 otherwise."""
        m = self.tcfg.microbatches
        diff = self.differentiated(model)
        flags = [p.requires_grad for p in diff.parameters()]
        for p in diff.parameters():
            p.requires_grad_(True)
        try:
            if m == 1:
                metrics, grads = self._grads_of(diff, batch)
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in model.parameters()]
                for i in range(m):
                    metrics = self.accumulate(diff, grads, microbatch(batch, m, i))
                grads = [g.div_(m) for g in grads]
        finally:
            for p, flag in zip(diff.parameters(), flags):
                p.requires_grad_(flag)
        return metrics, self.named_grads(model, grads)

    def __call__(self, model: Model, opt_state: dict, batch: dict):
        metrics, grads = self.grads(model, batch)
        _, opt_state, opt_metrics = apply_updates(
            self.tcfg.opt, dict(model.named_parameters()), grads, opt_state
        )
        metrics.update(opt_metrics)
        return model, opt_state, metrics


def microbatch(batch: dict, m: int, i: int) -> dict:
    """The ``i``-th of ``m`` runs of the batch's rows, laid out anew."""
    lead = next(iter(batch.values())).shape[0]
    if lead % m:
        raise ValueError(f"batch {lead} does not split into {m} microbatches")
    return {k: shard(v.chunk(m)[i], *BATCH_AXES[k]) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> TrainStep:
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, updating ``model`` and ``opt_state`` in place.

    ``batch`` holds tensors on the model's device (:func:`batch_to`).
    Gradient accumulation: the batch's leading axis is split into
    ``tcfg.microbatches`` chunks, each one's gradients added in float32 to
    float32 zeros and the sum divided by their count; the metrics are the
    last chunk's.  MoE capacity is each chunk's own.
    """
    return TrainStep(cfg, tcfg)
