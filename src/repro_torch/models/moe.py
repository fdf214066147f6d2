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

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    current_ctx,
    fsdp_gather,
    layout_of,
    local,
    shard,
    sharded_axes,
)
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
    return _route_by(cfg, moe.router, xt)


def _route_by(cfg: ModelConfig, router, xt):
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    # a stable descending sort puts tied probabilities in ascending id order
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, : cfg.moe_top_k], top_i[:, : cfg.moe_top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return logits, probs, top_p, top_i


def moe_apply(cfg: ModelConfig, moe: MoE, x):
    """x: (B, S, d) -> (out (B, S, d), aux metrics dict).

    Over a mesh the routing runs on each rank's tokens; the dispatch takes
    every token (gathered over the token axes) and each rank fills its own
    (experts, capacity) block of the buffers, so the capacity and the drops
    are the global ones; the combine sums each rank's share of every
    token's output over the mesh.
    """
    b, s, d = x.shape
    dtype = x.dtype
    t = b * s
    k = cfg.moe_top_k
    e = cfg.moe_experts
    cap = _capacity(cfg, t)
    # over a mesh the tokens keep the batch's layout (a partial sum reduced)
    xt = shard(x, "batch", "seq", "embed").reshape(t, d)

    # --- routing -------------------------------------------------------------
    logits, probs, top_p, top_i, picks = _route_tokens(cfg, moe, xt)

    # load-balance aux loss (Switch-style) + router z-loss
    density = picks.mean(dim=0)  # tokens per expert (x k)
    mean_prob = probs.mean(dim=0)
    aux_loss = e * torch.sum(density / k * mean_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # --- sort-based dispatch ---------------------------------------------------
    ctx = current_ctx()
    if ctx is None or layout_of(xt) is None:
        plan = _plan(top_i, e, cap)
        buf = _scatter(xt, plan, e, cap, 0, 0, e, cap)
        dropped = ((~plan[3]).sum() / (t * k)).float()
    else:
        lbuf = ctx.layout((e, cap, d), ("experts", "expert_cap", None))
        e0, e1 = ctx.shard_range(lbuf, 0, e)
        c0, c1 = ctx.shard_range(lbuf, 1, cap)
        rep = ctx.layout((t, d), (None, None))

        def dispatch(xt, top_i):
            plan = _plan(top_i, e, cap)
            buf = _scatter(xt, plan, e, cap, e0, c0, e1 - e0, c1 - c0)
            return buf, ((~plan[3]).sum() / (t * k)).float()

        # every token is gathered to every rank, which takes its own block's
        # rows: a token's gradient sums over the axes that split the buffers
        block_axes = sharded_axes(lbuf, ctx, 0) + sharded_axes(lbuf, ctx, 1)
        buf, dropped = local(dispatch, (lbuf, rep), (rep, rep), summed=(block_axes, None))(xt, top_i)
    # the dispatch buffers live (experts -> EP axis) x (capacity -> DP axes)
    buf = shard(buf, "experts", "expert_cap", None)

    # --- expert computation (batched matmuls over the expert axis) -----------
    gate = torch.bmm(buf, fsdp_gather(moe.w_gate.to(dtype)))
    up = torch.bmm(buf, fsdp_gather(moe.w_up.to(dtype)))
    act = F.silu(gate) * up
    act = shard(act, "experts", "expert_cap", None)
    out_buf = torch.bmm(act, fsdp_gather(moe.w_down.to(dtype)))
    out_buf = shard(out_buf, "experts", "expert_cap", None)

    # --- combine ---------------------------------------------------------------
    if ctx is None or layout_of(xt) is None:
        out = _gather(out_buf, plan, top_p, e, cap, 0, 0)
    else:
        from torch.distributed.tensor import Partial

        lout = tuple(Partial() if p.is_shard() else p for p in lbuf)

        def combine(out_buf, top_i, top_p):
            return _gather(out_buf, _plan(top_i, e, cap), top_p, e, cap, e0, c0)

        out = local(combine, lout, (lbuf, rep, rep), summed=(None, None, block_axes))(out_buf, top_i, top_p)
        out = out.redistribute(xt.device_mesh, layout_of(xt))

    if cfg.moe_shared_experts:
        out = out + mlp_apply(moe.shared, xt)

    metrics = {"aux_loss": aux_loss, "z_loss": z_loss, "dropped_frac": dropped}
    return out.reshape(b, s, d), metrics


def _route_tokens(cfg: ModelConfig, moe: MoE, xt):
    """:func:`_route_by` and each token's one-hot expert picks (T, E), on each
    rank's tokens over a mesh."""
    ctx = current_ctx()
    if ctx is None or layout_of(xt) is None:
        return _route_picks(cfg, moe.router, xt)
    lt = layout_of(xt)
    lw = ctx.layout(moe.router.shape, (None, None))
    tokens = sharded_axes(lt, ctx, 0)  # the router's gradient sums over the tokens
    return local(partial(_route_picks, cfg), (lt,) * 5, (lw, lt), summed=(tokens, None))(moe.router, xt)


def _route_picks(cfg: ModelConfig, router, xt):
    logits, probs, top_p, top_i = _route_by(cfg, router, xt)
    picks = F.one_hot(top_i, cfg.moe_experts).float().sum(dim=1)
    return logits, probs, top_p, top_i, picks


def _plan(top_i, e: int, cap: int):
    """The global dispatch order: (sort_idx, sorted_e, pos, keep, token_of)
    for the (T*k) assignments, stably sorted by expert id."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)  # (T*k,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # tokens per expert: an integer scatter-add, exact in any order, with no
    # read of the ids' maximum on the host (bincount's)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(t * k, device=top_i.device) - starts[sorted_e]  # rank within expert
    keep = pos < cap
    token_of = sort_idx // k  # source token of each sorted slot
    return sort_idx, sorted_e, pos, keep, token_of


def _dest(plan, e: int, cap: int, e0: int, c0: int, e_l: int, cap_l: int):
    """Each sorted slot's row in the (e_l * cap_l) block of the (e, cap)
    buffers that starts at expert e0, capacity c0 (the spare row
    e_l * cap_l if the slot is dropped or outside the block), and whether
    it is in the block."""
    _, sorted_e, pos, keep, _ = plan
    if (e_l, cap_l) == (e, cap):
        return torch.where(keep, sorted_e * cap + pos, e * cap), keep
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + e_l) & (pos >= c0) & (pos < c0 + cap_l)
    return torch.where(mine, (sorted_e - e0) * cap_l + (pos - c0), e_l * cap_l), mine


def _scatter(xt, plan, e: int, cap: int, e0: int, c0: int, e_l: int, cap_l: int):
    """The (e_l, cap_l, d) block of dispatch buffers starting at (e0, c0)."""
    d = xt.shape[1]
    dest, _ = _dest(plan, e, cap, e0, c0, e_l, cap_l)
    # slots outside the block go to the spare row e_l * cap_l, cut below
    buf = torch.zeros((e_l * cap_l + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[plan[4]]
    return buf[: e_l * cap_l].reshape(e_l, cap_l, d)


def _gather(out_buf, plan, top_p, e: int, cap: int, e0: int, c0: int):
    """Each token's output from the block of buffers ``out_buf`` starting at
    (e0, c0): its k contributions summed in ascending sorted-slot order."""
    e_l, cap_l, d = out_buf.shape
    sort_idx = plan[0]
    t, k = top_p.shape
    dest, mine = _dest(plan, e, cap, e0, c0, e_l, cap_l)
    gathered = out_buf.reshape(e_l * cap_l, d)[torch.clamp_max(dest, e_l * cap_l - 1)]
    gathered = torch.where(mine[:, None], gathered, 0.0)
    weight = top_p.reshape(-1)[sort_idx].to(out_buf.dtype)
    contrib = gathered * weight[:, None]  # (T*k, d), in sorted-slot order
    slot_of = torch.empty_like(sort_idx)
    slot_of[sort_idx] = torch.arange(t * k, device=out_buf.device)
    slots = slot_of.reshape(t, k).sort(dim=1).values  # each token's slots, ascending
    out = torch.zeros((t, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        out = out + contrib[slots[:, j]]
    return out


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
