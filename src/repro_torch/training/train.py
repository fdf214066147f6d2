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
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
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


def compute_copy(cfg: ModelConfig, device, dtype: torch.dtype) -> Model:
    """An uninitialised :class:`Model` on ``device`` whose >= 2-D weights
    are ``dtype`` (the 1-D ones float32), every weight a leaf that requires
    grad; built on the meta device first, so no float32 copy is allocated."""
    copy = Model(cfg, device="meta")
    for mod in copy.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            dt = dtype if p.dim() >= 2 else p.dtype
            setattr(mod, name, nn.Parameter(torch.empty(p.shape, dtype=dt, device=device)))
    return copy


class TrainStep:
    """``step(model, opt_state, batch) -> (model, opt_state, metrics)``,
    updating ``model`` and ``opt_state`` in place (:func:`make_train_step`)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig):
        self.cfg, self.tcfg = cfg, tcfg
        self.gather = DTYPES[tcfg.param_gather_dtype]
        self._copy = None  # the compute copy, built at the first step

    def _differentiated(self, model: Model) -> Model:
        if self.gather == torch.float32:
            return model
        if self._copy is None or self._copy.device != model.device:
            self._copy = compute_copy(self.cfg, model.device, self.gather)
        with torch.no_grad():
            for c, p in zip(self._copy.parameters(), model.parameters()):
                c.copy_(p)
        return self._copy

    def _grads_of(self, model: Model, batch: dict):
        loss, metrics = lm_loss(self.cfg, model, batch, self.tcfg.remat)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        return {k: torch.as_tensor(v).detach() for k, v in metrics.items()}, grads

    def grads(self, model: Model, batch: dict) -> tuple[dict, dict]:
        """The loss's metrics and each weight's gradient by name (``None``
        for a weight the loss does not reach): bf16 for the >= 2-D weights
        under the bf16 cast with one microbatch, float32 otherwise."""
        m = self.tcfg.microbatches
        lead = next(iter(batch.values())).shape[0]
        if lead % m:
            raise ValueError(f"batch {lead} does not split into {m} microbatches")
        diff = self._differentiated(model)
        flags = [p.requires_grad for p in diff.parameters()]
        for p in diff.parameters():
            p.requires_grad_(True)
        try:
            if m == 1:
                metrics, grads = self._grads_of(diff, batch)
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in model.parameters()]
                for i in range(m):
                    micro = {k: v.chunk(m)[i] for k, v in batch.items()}
                    metrics, chunk = self._grads_of(diff, micro)
                    for acc, g in zip(grads, chunk):
                        if g is not None:
                            acc.add_(g)
                    del chunk
                grads = [g.div_(m) for g in grads]
        finally:
            for p, flag in zip(diff.parameters(), flags):
                p.requires_grad_(flag)
        return metrics, dict(zip((n for n, _ in model.named_parameters()), grads))

    def __call__(self, model: Model, opt_state: dict, batch: dict):
        metrics, grads = self.grads(model, batch)
        _, opt_state, opt_metrics = apply_updates(
            self.tcfg.opt, dict(model.named_parameters()), grads, opt_state
        )
        metrics.update(opt_metrics)
        return model, opt_state, metrics


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
