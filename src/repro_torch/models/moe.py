"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch: the
port of :mod:`repro.models.moe`.

  1. route: top-k expert ids (ties to the lower id, as ``lax.top_k``) and
     renormalised probabilities per token;
  2. stable-sort the (T*k) assignments by expert id;
  3. rank within expert from the sorted prefix; drop beyond capacity;
  4. scatter tokens into (E, capacity, d) buffers (one spare row takes the
     dropped ones), run the expert SwiGLU as batched matmuls, gather back
     and sum each token's k contributions in ascending sorted-slot order: a
     fixed order with no atomics.

Shared experts (DeepSeek-V2) are dense SwiGLUs applied to every token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, mlp_apply, param, truncated_normal_


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, fd, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.moe_experts
        self.router = param(d, e, device=device)
        self.w_gate = param(e, d, fd, device=device)
        self.w_up = param(e, d, fd, device=device)
        self.w_down = param(e, fd, d, device=device)
        if cfg.moe_shared_experts:
            self.shared = MLP(d, cfg.moe_shared_experts * fd, device=device)

    def reset_parameters(self, generator) -> None:
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            truncated_normal_(w, 1.0, generator)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(generator)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.moe_top_k / cfg.moe_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _route(cfg: ModelConfig, moe: MoE, xt):
    """Router logits, probabilities and the renormalised top-k."""
    logits = xt.float() @ moe.router.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    # a stable descending sort puts tied probabilities in ascending id order
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, : cfg.moe_top_k], top_i[:, : cfg.moe_top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, top_p, top_i


def moe_apply(cfg: ModelConfig, moe: MoE, x):
    """x: (B, S, d) -> (out (B, S, d), aux metrics dict)."""
    b, s, d = x.shape
    dtype = x.dtype
    t = b * s
    k = cfg.moe_top_k
    e = cfg.moe_experts
    cap = _capacity(cfg, t)
    xt = x.reshape(t, d)

    # --- routing -------------------------------------------------------------
    logits, probs, top_p, top_i = _route(cfg, moe, xt)

    # load-balance aux loss (Switch-style) + router z-loss
    density = F.one_hot(top_i, e).float().sum(dim=1).mean(dim=0)  # tokens per expert (x k)
    mean_prob = probs.mean(dim=0)
    aux_loss = e * torch.sum(density / k * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # --- sort-based dispatch ---------------------------------------------------
    flat_e = top_i.reshape(-1)  # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=e)  # (E,)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * k, device=x.device) - starts[sorted_e]  # rank within expert
    keep = pos < cap
    token_of = sort_idx // k  # source token of each sorted slot

    # dropped slots go to the spare row e * cap, cut below
    dest = torch.where(keep, sorted_e * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=x.device)
    buf[dest] = xt[token_of]
    buf = buf[: e * cap].reshape(e, cap, d)

    # --- expert computation (batched matmuls over the expert axis) -----------
    gate = torch.bmm(buf, moe.w_gate.to(dtype))
    up = torch.bmm(buf, moe.w_up.to(dtype))
    act = F.silu(gate) * up
    out_buf = torch.bmm(act, moe.w_down.to(dtype))

    # --- combine ---------------------------------------------------------------
    gathered = out_buf.reshape(e * cap, d)[torch.clamp_max(dest, e * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weight = top_p.reshape(-1)[sort_idx].to(dtype)
    contrib = gathered * weight[:, None]  # (T*k, d), in sorted-slot order
    slot_of = torch.empty_like(sort_idx)
    slot_of[sort_idx] = torch.arange(t * k, device=x.device)
    slots = slot_of.reshape(t, k).sort(dim=1).values  # each token's slots, ascending
    out = torch.zeros((t, d), dtype=dtype, device=x.device)
    for j in range(k):
        out = out + contrib[slots[:, j]]

    if cfg.moe_shared_experts:
        out = out + mlp_apply(moe.shared, xt)

    dropped = ((~keep).sum() / (t * k)).float()
    metrics = {"aux_loss": aux_loss, "z_loss": z_loss, "dropped_frac": dropped}
    return out.reshape(b, s, d), metrics


def moe_ref_dense(cfg: ModelConfig, moe: MoE, x):
    """Oracle: run EVERY expert densely and mix by the router's top-k
    probabilities.  Equal to :func:`moe_apply` whenever no token is dropped."""
    b, s, d = x.shape
    dtype = x.dtype
    xt = x.reshape(b * s, d)
    _, probs, top_p, top_i = _route(cfg, moe, xt)
    weights = torch.zeros_like(probs).scatter(1, top_i, top_p)

    gate = torch.einsum("td,edf->etf", xt, moe.w_gate.to(dtype))
    up = torch.einsum("td,edf->etf", xt, moe.w_up.to(dtype))
    act = F.silu(gate) * up
    per_expert = torch.einsum("etf,efd->etd", act, moe.w_down.to(dtype))
    out = torch.einsum("etd,te->td", per_expert, weights.to(dtype))
    if cfg.moe_shared_experts:
        out = out + mlp_apply(moe.shared, xt)
    return out.reshape(b, s, d)
