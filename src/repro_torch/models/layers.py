"""Shared neural layers: the port of :mod:`repro.models.layers`.

Parameters are float32 ``nn.Parameter`` tensors (``param_dtype``) held by
small modules whose attribute names are the JAX package's dict keys, so a
JAX parameter tree loads by name (:mod:`repro_torch.models.weights`).  Every
matmul casts its weight to the activation dtype per call, as the reference
does; norms, softmax, rotary angles and logits run in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (
    current_ctx,
    fsdp_gather,
    layout_of,
    local,
    replicate_on,
    sharded_axes,
)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}

# the named range around attention's streaming, for torch.profiler (lm_perf.py
# splits a decode step's device time by it); a few microseconds of host time
# when no profiler runs
ATTENTION_RANGE = "lm.attention"


def act_dtype(cfg) -> torch.dtype:
    """The activation dtype named by ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def check_matmul_precision() -> None:
    """Raise if float32 matmuls may run in TF32.

    The head and the MoE router multiply in float32; TF32 there would move
    the logits and the routing away from the reference.
    """
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmuls must not use TF32: set torch.backends.cuda.matmul.allow_tf32 "
            "= False and torch.set_float32_matmul_precision('highest')"
        )


def param(*shape, device) -> nn.Parameter:
    """An uninitialised float32 serving weight (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device), requires_grad=False)


_SQRT2 = math.sqrt(2.0)
_TRUNC_LO = math.erf(-2.0 / _SQRT2)  # the standard normal's CDF at -2 and 2, as erf
_TRUNC_HI = math.erf(2.0 / _SQRT2)


def truncated_normal_(t: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with ``scale / sqrt(fan_in)`` times a standard
    normal truncated to [-2, 2] (inverse CDF, as ``jax.random.truncated_normal``)."""
    shape = t.shape
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / np.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(_TRUNC_LO, _TRUNC_HI, generator=generator)
        t.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0).mul_(std)
    return t


# --- RMSNorm ------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, device):
        super().__init__()
        self.scale = param(dim, device=device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(dtype)


# --- Rotary embeddings --------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer (over a mesh: on the
    local shards, positions sharded over the batch as x is)."""
    lay = layout_of(x)
    return local(_rope, lay, (lay, layout_of(positions), None))(x, positions, theta)


def _rope(x, positions, theta):
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- Blockwise (online-softmax) attention ------------------------------------
#
# The reference's streaming over KV blocks, in float32, with its block sizes
# (1024 for the forward and prefill, 2048 for extend and decode): the peak
# footprint is O(S * block) instead of O(S^2).  Not a finished attention
# kernel: q, k and v are cast to float32 before they attend, as the
# reference does.


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    causal: bool,
    q_offset: int = 0,  # absolute position of q[0] (decode)
    kv_valid_len=None,  # mask KV positions >= this (ragged decode cache)
    kv_block: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    with torch.profiler.record_function(ATTENTION_RANGE):
        ctx = current_ctx()
        if ctx is None or layout_of(q) is None:
            return _stream(q, k, v, causal, q_offset, kv_valid_len, kv_block, scale)
        return _stream_sharded(ctx, q, k, v, causal, q_offset, kv_valid_len, kv_block, scale)


def _stream_sharded(ctx, q, k, v, causal, q_offset, kv_valid_len, kv_block, scale):
    """The stream on each rank's shards.  Batch shards stay where they are.

    - KV sharded over its sequence (the long-context decode cache): every
      rank streams its own keys for all the query heads, then the partial
      softmax statistics are combined over that mesh axis.
    - Query heads sharded, KV heads replicated (GQA heads that do not
      divide the axis): each rank takes the KV heads of its own queries.
    - Otherwise the heads shard alike (or not at all) and the stream is
      local.
    """
    lq, lk, lv = layout_of(q), layout_of(k), layout_of(v)
    seq_axes = sharded_axes(lk, ctx, 1)
    if seq_axes:
        if len(seq_axes) != 1:
            raise ValueError(f"KV sequence sharded over {seq_axes}: one mesh axis is supported")
        axis = seq_axes[0]
        lq = replicate_on(lq, ctx, axis)
        lo = ctx.coordinate(axis) * (k.shape[1] // ctx.sizes[axis])
        group = ctx.mesh.get_group(axis)

        def seq_fn(q, k, v):
            m, l, acc = _stream_stats(
                q, k, v, causal, q_offset, kv_valid_len, kv_block, scale, kv_offset=lo
            )
            return _combine(m, l, acc, group).to(q.dtype)

        return local(seq_fn, lq, (lq, lk, lv))(q, k, v)

    q_heads, k_heads = sharded_axes(lq, ctx, 2), sharded_axes(lk, ctx, 2)
    kv_range = None
    if k_heads and q_heads != k_heads:
        lk, lv = replicate_on(lk, ctx, *k_heads), replicate_on(lv, ctx, *k_heads)
        k_heads = []
    if q_heads and not k_heads:
        if len(q_heads) != 1:
            raise ValueError(f"query heads sharded over {q_heads}: one mesh axis is supported")
        h, hkv = q.shape[2], k.shape[2]
        h_l, groups = h // ctx.sizes[q_heads[0]], h // hkv
        if h_l % groups and groups % h_l:
            raise ValueError(f"{h_l} local query heads do not align with {groups}-head groups")
        off = ctx.coordinate(q_heads[0]) * h_l
        kv_range = (off // groups, (off + h_l - 1) // groups + 1)

    def fn(q, k, v):
        if kv_range is not None:
            k, v = k[:, :, kv_range[0] : kv_range[1]], v[:, :, kv_range[0] : kv_range[1]]
        return _stream(q, k, v, causal, q_offset, kv_valid_len, kv_block, scale)

    # KV whole on the axis that splits the query heads: each rank's KV
    # gradient is its own heads' share
    kv_summed = q_heads if kv_range is not None else None
    return local(fn, lq, (lq, lk, lv), summed=(None, kv_summed, kv_summed))(q, k, v)


def _combine(m, l, acc, group):
    """One softmax over every rank's keys from each rank's (max, sum,
    weighted values) over its own."""
    from torch.distributed import _functional_collectives as funcol

    m_all = funcol.all_reduce(m, "max", group)
    m_safe = torch.where(torch.isfinite(m_all), m_all, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = funcol.all_reduce(l * alpha, "sum", group)
    acc = funcol.all_reduce(acc * alpha[..., None], "sum", group)
    return acc / torch.clamp_min(l[..., None], 1e-30)


def _stream(q, k, v, causal, q_offset, kv_valid_len, kv_block, scale):
    m, l, acc = _stream_stats(q, k, v, causal, q_offset, kv_valid_len, kv_block, scale)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _stream_stats(q, k, v, causal, q_offset, kv_valid_len, kv_block, scale, kv_offset=0):
    """The running (max, sum, weighted values) over the keys, which sit at
    absolute positions ``kv_offset`` onwards."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    groups = h // hkv
    scale = float(scale) if scale is not None else float(1.0 / np.sqrt(hd))

    kv_block = min(kv_block, sk)
    if sk % kv_block:
        pad = kv_block - sk % kv_block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid_len = kv_offset + sk if kv_valid_len is None else kv_valid_len
        sk = sk + pad
    n_blocks = sk // kv_block

    # the flat head axis, KV repeated to the full head count per block (GQA)
    qf = q.float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, sq, h), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        lo = blk * kv_block
        kb = k[:, lo : lo + kv_block].float()
        vb = v[:, lo : lo + kv_block].float()
        if groups > 1:
            # each KV head repeated for its query heads, as repeat_interleave
            # would; expand's backward is a sum, which is deterministic on the
            # card (repeat_interleave's is an atomic index_add)
            kb = kb[:, :, :, None].expand(-1, -1, -1, groups, -1).reshape(b, kv_block, h, hd)
            vb = vb[:, :, :, None].expand(-1, -1, -1, groups, -1).reshape(b, kv_block, h, hd)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb)  # (B, Sq, H, kv_block)
        kv_pos = (kv_offset + lo) + torch.arange(kv_block, device=q.device)
        mask = None
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]
        if kv_valid_len is not None:
            valid = (kv_pos < kv_valid_len)[None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
            mask = mask[None, :, None, :]
            s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if mask is not None:
            p = p.masked_fill(~mask, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vb)
        m = m_new
    return m, l, acc


def cache_write(cache: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """``cache[:, start : start + S] = new`` in place; returns the cache.

    Over a mesh each rank writes into its own shard: where the cache is
    sharded over its sequence, the part of ``[start, start + S)`` it holds.
    """
    ctx = current_ctx()
    lc = layout_of(cache)
    if ctx is None or lc is None:
        cache[:, start : start + new.shape[1]] = new
        return cache
    seq_axes = sharded_axes(lc, ctx, 1)
    lo = 0
    if seq_axes:
        if len(seq_axes) != 1:
            raise ValueError(f"cache sequence sharded over {seq_axes}: one mesh axis is supported")
        lo = ctx.coordinate(seq_axes[0]) * (cache.shape[1] // ctx.sizes[seq_axes[0]])

    def fn(c, n):
        a, b = max(start, lo), min(start + n.shape[1], lo + c.shape[1])
        if a < b:
            c[:, a - lo : b - lo] = n[:, a - start : b - start]
        return c

    return local(fn, lc, (lc, replicate_on(lc, ctx, *seq_axes)))(cache, new)


# --- SwiGLU MLP ---------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device):
        super().__init__()
        self.w_gate = param(d_model, d_ff, device=device)
        self.w_up = param(d_model, d_ff, device=device)
        self.w_down = param(d_ff, d_model, device=device)

    def reset_parameters(self, generator) -> None:
        for w in (self.w_gate, self.w_up, self.w_down):
            truncated_normal_(w, 1.0, generator)


def mlp_apply(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    gate = x @ fsdp_gather(mlp.w_gate.to(dtype))
    up = x @ fsdp_gather(mlp.w_up.to(dtype))
    return (F.silu(gate) * up) @ fsdp_gather(mlp.w_down.to(dtype))


# --- Embedding / head ---------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, device):
        super().__init__()
        self.table = param(vocab, d_model, device=device)

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.table.normal_(generator=generator).mul_(0.02)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather the rows, then cast: the reference's cast-then-gather bits
    # without casting the whole table.  Indexing, not index_select: its
    # backward on the card is a sorted accumulation, deterministic where
    # index_select's atomic index_add is not
    ctx = current_ctx()
    if ctx is None or layout_of(table) is None:
        rows = table[tokens.reshape(-1)]
        return rows.reshape(*tokens.shape, table.shape[1]).to(dtype)
    # over a mesh, rows sharded over the vocab: each rank looks up the tokens
    # its rows hold (zeros elsewhere), and the results are summed
    from torch.distributed.tensor import Partial

    lt = layout_of(table)
    row_axes = sharded_axes(lt, ctx, 0)
    v0, _ = ctx.shard_range(lt, 0, table.shape[0])
    ltok = ctx.layout(tokens.shape, ("batch",) + ("seq",) * (tokens.dim() - 1))
    lout = tuple(Partial() if a in row_axes else p for a, p in zip(ctx.sizes, ltok))

    def lookup(table, tokens):
        ids = tokens - v0
        inside = (ids >= 0) & (ids < table.shape[0])
        rows = table[torch.where(inside, ids, 0).reshape(-1)]
        rows = torch.where(inside.reshape(-1, 1), rows, 0.0)
        return rows.reshape(*tokens.shape, table.shape[1]).to(dtype)

    # the table's gradient sums over the tokens, which the batch axes split
    batch_axes = sharded_axes(ltok, ctx, 0)
    return local(lookup, lout, (lt, ltok), summed=(batch_axes, None))(table, tokens)


class Head(nn.Module):
    def __init__(self, d_model: int, vocab: int, *, device):
        super().__init__()
        self.w = param(d_model, vocab, device=device)

    def reset_parameters(self, generator) -> None:
        truncated_normal_(self.w, 1.0, generator)


def head_apply(head: Head, x: torch.Tensor) -> torch.Tensor:
    # logits in float32 for a stable softmax; the weight may be a bf16
    # compute copy (training), which is cast up as the reference does
    return x.float() @ fsdp_gather(head.w).float()
