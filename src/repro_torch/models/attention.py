"""GQA attention (with optional per-head QK-norm) and its KV-cache serving
path: the port of :mod:`repro.models.attention`.

The cache is one ``(B, max_len, Hkv, hd)`` pair per layer, written in place.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import (
    distribute,
    fsdp_gather,
    merge_heads,
    shard,
    split_heads,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    RMSNorm,
    apply_rope,
    blockwise_attention,
    cache_write,
    param,
    rmsnorm,
    truncated_normal_,
)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        hd = cfg.resolved_head_dim
        self.wq = param(cfg.d_model, cfg.n_heads * hd, device=device)
        self.wk = param(cfg.d_model, cfg.n_kv_heads * hd, device=device)
        self.wv = param(cfg.d_model, cfg.n_kv_heads * hd, device=device)
        self.wo = param(cfg.n_heads * hd, cfg.d_model, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device=device)
            self.k_norm = RMSNorm(hd, device=device)

    def reset_parameters(self, generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            truncated_normal_(w, 1.0, generator)
        if hasattr(self, "q_norm"):
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()


def _project_qkv(cfg: ModelConfig, attn: Attention, x, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dtype = x.dtype
    q = split_heads(x @ fsdp_gather(attn.wq.to(dtype)), cfg.n_heads, "heads")
    k = split_heads(x @ fsdp_gather(attn.wk.to(dtype)), cfg.n_kv_heads, "kv_heads")
    v = split_heads(x @ fsdp_gather(attn.wv.to(dtype)), cfg.n_kv_heads, "kv_heads")
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    if cfg.qk_norm:
        q = rmsnorm(attn.q_norm.scale, q, cfg.norm_eps)
        k = rmsnorm(attn.k_norm.scale, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg: ModelConfig, attn: Attention, x, positions, kv_block: int = 1024):
    """Training / encoding path (no cache)."""
    q, k, v = _project_qkv(cfg, attn, x, positions)
    out = blockwise_attention(q, k, v, causal=cfg.causal, kv_block=kv_block)
    return merge_heads(out, "heads") @ fsdp_gather(attn.wo.to(x.dtype))


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype, *, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_prefill(cfg: ModelConfig, attn: Attention, x, positions, cache, kv_block=1024):
    """Full-sequence forward that also fills cache[:, :S]."""
    q, k, v = _project_qkv(cfg, attn, x, positions)
    out = blockwise_attention(q, k, v, causal=cfg.causal, kv_block=kv_block)
    cache["k"] = cache_write(cache["k"], k, 0)
    cache["v"] = cache_write(cache["v"], v, 0)
    return merge_heads(out, "heads") @ fsdp_gather(attn.wo.to(x.dtype)), cache


def attn_extend(cfg: ModelConfig, attn: Attention, x, cache, pos: int, kv_block: int = 2048):
    """Extend the cache by S tokens starting at absolute position ``pos`` and
    attend causally against everything cached so far.  S=1 is decode;
    S=chunk is chunked prefill."""
    b, s, _ = x.shape
    positions = distribute((pos + torch.arange(s, device=x.device)).expand(b, s), "batch", "seq")
    q, k, v = _project_qkv(cfg, attn, x, positions)
    cache["k"] = cache_write(cache["k"], k, pos)
    cache["v"] = cache_write(cache["v"], v, pos)
    out = blockwise_attention(
        q,
        cache["k"],
        cache["v"],
        causal=True,
        q_offset=pos,
        kv_valid_len=pos + s,
        kv_block=kv_block,
    )
    return merge_heads(out, "heads") @ fsdp_gather(attn.wo.to(x.dtype)), cache


def attn_decode(cfg: ModelConfig, attn: Attention, x, cache, pos: int, kv_block: int = 2048):
    """One-token step: x (B, 1, d); pos the current absolute position."""
    return attn_extend(cfg, attn, x, cache, pos, kv_block=kv_block)
