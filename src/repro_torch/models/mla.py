"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the port of
:mod:`repro.models.mla`.

KV is compressed into a per-token latent ``c_kv`` of rank ``kv_lora_rank``
plus one shared RoPE key of ``qk_rope_head_dim``: the serving cache holds
``kv_lora_rank + qk_rope_head_dim`` values per token whatever the head
count.  Queries carry a no-RoPE part (matched against the latent through the
absorbed up-projection) and a RoPE part (matched against the shared key).
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    current_ctx,
    distribute,
    fsdp_gather,
    layout_of,
    local,
    sharded_axes,
    split_heads,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ATTENTION_RANGE,
    RMSNorm,
    apply_rope,
    cache_write,
    param,
    rmsnorm,
    truncated_normal_,
)


class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            self.wq_a = param(d, cfg.q_lora_rank, device=device)
            self.q_a_norm = RMSNorm(cfg.q_lora_rank, device=device)
        self.wq_b = param(cfg.q_lora_rank or d, nh * qd, device=device)
        self.w_kv_a = param(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, device=device)
        self.kv_a_norm = RMSNorm(cfg.kv_lora_rank, device=device)
        self.w_k_b = param(cfg.kv_lora_rank, nh * cfg.qk_nope_head_dim, device=device)
        self.w_v_b = param(cfg.kv_lora_rank, nh * cfg.v_head_dim, device=device)
        self.wo = param(nh * cfg.v_head_dim, d, device=device)

    def reset_parameters(self, generator) -> None:
        if hasattr(self, "wq_a"):
            truncated_normal_(self.wq_a, 1.0, generator)
            self.q_a_norm.reset_parameters()
        for w in (self.wq_b, self.w_kv_a, self.w_k_b, self.w_v_b, self.wo):
            truncated_normal_(w, 1.0, generator)
        self.kv_a_norm.reset_parameters()


def _queries(cfg: ModelConfig, mla: MLA, x, positions):
    b, s, _ = x.shape
    dtype = x.dtype
    if cfg.q_lora_rank:
        cq = rmsnorm(mla.q_a_norm.scale, x @ fsdp_gather(mla.wq_a.to(dtype)), cfg.norm_eps)
    else:
        cq = x
    q = split_heads(cq @ fsdp_gather(mla.wq_b.to(dtype)), cfg.n_heads, "heads")
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent_kv(cfg: ModelConfig, mla: MLA, x, positions):
    kv = x @ fsdp_gather(mla.w_kv_a.to(x.dtype))  # (B, S, rank + rope)
    c_kv, k_rope = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(mla.kv_a_norm.scale, c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _attend(cfg: ModelConfig, mla: MLA, q_nope, q_rope, c_kv, k_rope, kv_valid_len):
    """Attention against the latent cache, streamed over KV blocks of 2048.

    q_nope is absorbed into the latent up-projection (q_nope @ w_k_b^T per
    head), so scores are taken in the latent space with no per-head K, and
    the values are projected after the stream.

    Over a mesh it runs on each rank's shards: with the latent rank sharded
    (the decode cache), each rank scores its slice of the rank (and of the
    RoPE key) for every head and the partial scores are summed over that
    axis once per block; otherwise each rank takes its own heads.
    """
    with torch.profiler.record_function(ATTENTION_RANGE):
        args = (q_nope, q_rope, c_kv, k_rope, mla.w_k_b, mla.w_v_b)
        ctx = current_ctx()
        if ctx is None or layout_of(q_nope) is None:
            return _absorbed(cfg, kv_valid_len, *args)
        cache_names = ("batch", "kv_seq", "mla_rank")
        lc, lr = ctx.layout(c_kv.shape, cache_names), ctx.layout(k_rope.shape, cache_names)
        if sharded_axes(lc, ctx, 1):
            raise ValueError("an MLA latent cache sharded over its sequence is not supported")
        if sharded_axes(lc, ctx, 2):  # the decode cache: DTensor products around the stream
            return _absorbed(cfg, kv_valid_len, *args,
                             stream=_rank_sharded_stream(ctx, lc, lr, kv_valid_len))
        b, sq, nh, _ = q_nope.shape
        heads = ctx.spec((b, sq, nh), ("batch", "seq", "heads"))
        lq = ctx.placements(heads + (None,))
        lw = ctx.placements((None, heads[2]))  # (rank, H * d): the heads are its major part
        lo = ctx.placements(heads)  # (B, Sq, H * v_dim)
        # the up-projections' gradients sum over the batch axes, the latent
        # KV's over the axes that split the heads
        batch, split = sharded_axes(lq, ctx, 0), sharded_axes(lq, ctx, 2)
        return local(partial(_absorbed, cfg, kv_valid_len), lo, (lq, lq, lc, lr, lw, lw),
                     summed=(None, None, split, split, batch, batch))(*args)


def _absorbed(cfg: ModelConfig, kv_valid_len, q_nope, q_rope, c_kv, k_rope, w_k_b, w_v_b,
              stream=None):
    """The absorbed attention; ``stream(q_lat, q_rope, c_kv, k_rope, scale)``
    runs the latent stream (:func:`_latent_blocks` by default)."""
    b, sq, nh, _ = q_nope.shape
    dtype = q_nope.dtype
    rank = cfg.kv_lora_rank
    w_k_b = w_k_b.float().reshape(rank, nh, cfg.qk_nope_head_dim)
    w_v_b = w_v_b.float().reshape(rank, nh, cfg.v_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_k_b)  # (B, Sq, H, rank)
    scale = float(1.0 / np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
    if stream is None:
        lat_out = _latent_blocks(q_lat, q_rope.float(), c_kv, k_rope, kv_valid_len, scale)
    else:
        lat_out = stream(q_lat, q_rope.float(), c_kv, k_rope, scale)
    out = torch.einsum("bqhr,rhd->bqhd", lat_out, w_v_b)  # (B, Sq, H, v_dim)
    return out.reshape(b, sq, nh * cfg.v_head_dim).to(dtype)


def _rank_sharded_stream(ctx, lc, lr, kv_valid_len):
    """The latent stream over a cache sharded on its rank: each rank scores
    its slice of the rank (and of the RoPE key) for every head, and the
    partial scores are summed over that mesh axis once per block."""
    (axis,) = sharded_axes(lc, ctx, 2)
    group, rope_sharded = ctx.mesh.get_group(axis), bool(sharded_axes(lr, ctx, 2))

    def stream(q_lat, q_rope, c_kv, k_rope, scale):
        lq = ctx.layout(q_lat.shape, ("batch", "seq", None, "mla_rank"))
        lqr = ctx.layout(q_rope.shape, ("batch", "seq", None, "mla_rank"))

        def fn(q_lat, q_rope, c_kv, k_rope):
            return _latent_blocks(q_lat, q_rope, c_kv, k_rope, kv_valid_len, scale, group,
                                  rope_sharded)

        return local(fn, lq, (lq, lqr, lc, lr))(q_lat, q_rope, c_kv, k_rope)

    return stream


def _latent_blocks(q_lat, q_rope, c_kv, k_rope, kv_valid_len, scale, group=None,
                   rope_sharded=False):
    """``group``: the scores are partial sums over the latent rank, summed
    over ``group`` (the RoPE term with them when ``rope_sharded``)."""
    b, sq, nh, rank = q_lat.shape
    sk = c_kv.shape[1]
    block = min(2048, sk)
    if sk % block:
        pad = block - sk % block
        c_kv = F.pad(c_kv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
        sk += pad
    n_blocks = sk // block
    dev = q_lat.device
    q_pos = (kv_valid_len - sq) + torch.arange(sq, device=dev)  # absolute query positions

    m = torch.full((b, sq, nh), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, nh), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, nh, rank), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        lo = blk * block
        cb = c_kv[:, lo : lo + block].float()
        rb = k_rope[:, lo : lo + block].float()
        s = torch.einsum("bqhr,bkr->bqhk", q_lat, cb)
        if group is None:
            s = s + torch.einsum("bqhd,bkd->bqhk", q_rope, rb)
        else:
            from torch.distributed import _functional_collectives as funcol

            rope = torch.einsum("bqhd,bkd->bqhk", q_rope, rb)
            if rope_sharded:
                s = funcol.all_reduce(s + rope, "sum", group)
            else:
                s = funcol.all_reduce(s, "sum", group) + rope
        s = s * scale
        kv_pos = lo + torch.arange(block, device=dev)
        mask = (q_pos[:, None] >= kv_pos[None, :]) & (kv_pos < kv_valid_len)[None, :]
        mask = mask[None, :, None, :]
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        # accumulate in latent space; project to V after the stream
        acc = acc * alpha[..., None] + torch.einsum("bqhk,bkr->bqhr", p, cb)
        m = m_new
    return acc / torch.clamp_min(l[..., None], 1e-30)  # (B, Sq, H, rank)


def mla_forward(cfg: ModelConfig, mla: MLA, x, positions):
    s = x.shape[1]
    q_nope, q_rope = _queries(cfg, mla, x, positions)
    c_kv, k_rope = _latent_kv(cfg, mla, x, positions)
    out = _attend(cfg, mla, q_nope, q_rope, c_kv, k_rope, kv_valid_len=s)
    return out @ fsdp_gather(mla.wo.to(x.dtype))


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype, *, device):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_prefill(cfg: ModelConfig, mla: MLA, x, positions, cache):
    s = x.shape[1]
    q_nope, q_rope = _queries(cfg, mla, x, positions)
    c_kv, k_rope = _latent_kv(cfg, mla, x, positions)
    cache["c_kv"] = cache_write(cache["c_kv"], c_kv, 0)
    cache["k_rope"] = cache_write(cache["k_rope"], k_rope, 0)
    out = _attend(cfg, mla, q_nope, q_rope, c_kv, k_rope, kv_valid_len=s)
    return out @ fsdp_gather(mla.wo.to(x.dtype)), cache


def mla_extend(cfg: ModelConfig, mla: MLA, x, cache, pos: int):
    """Extend the latent cache by S tokens at position ``pos`` (S=1: decode;
    S=chunk: chunked prefill) and attend causally against the cache."""
    b, s, _ = x.shape
    positions = distribute((pos + torch.arange(s, device=x.device)).expand(b, s), "batch", "seq")
    q_nope, q_rope = _queries(cfg, mla, x, positions)
    c_kv, k_rope = _latent_kv(cfg, mla, x, positions)
    cache["c_kv"] = cache_write(cache["c_kv"], c_kv, pos)
    cache["k_rope"] = cache_write(cache["k_rope"], k_rope, pos)
    out = _attend(
        cfg, mla, q_nope, q_rope, cache["c_kv"], cache["k_rope"], kv_valid_len=pos + s
    )
    return out @ fsdp_gather(mla.wo.to(x.dtype)), cache


def mla_decode(cfg: ModelConfig, mla: MLA, x, cache, pos: int):
    return mla_extend(cfg, mla, x, cache, pos)
