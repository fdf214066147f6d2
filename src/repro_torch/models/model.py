"""Model assembly and the serve paths: the port of :mod:`repro.models.model`.

The reference stacks each period of its layer pattern on a leading axis for
``lax.scan``; here the model is one :class:`Block` module per layer (the
prologue's dense layers first) and the caches are one entry per layer,
updated in place.  ``model_forward``, ``cache_init``, ``model_prefill``,
``model_prefill_chunked`` and ``model_decode`` keep the reference's names,
as functions over a :class:`Model`.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from repro_torch.core.adaptive import resolve_device
from repro_torch.distributed.sharding import bound, distribute, fsdp_gather, shard
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    MLP,
    Embedding,
    Head,
    RMSNorm,
    act_dtype,
    check_matmul_precision,
    embedding_lookup,
    head_apply,
    mlp_apply,
    rmsnorm,
)

# ---------------------------------------------------------------------------
# modules and init
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: norm, mixer (attention, MLA or Mamba-2), norm, FFN (dense
    SwiGLU, MoE, or none for pure-Mamba blocks)."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, *, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = RMSNorm(d, device=device)
        if cfg.layer_kind(layer_idx) == "ssm":
            self.mixer = ssm_mod.Mamba2(cfg, device=device)
        elif cfg.use_mla:
            self.mixer = mla_mod.MLA(cfg, device=device)
        else:
            self.mixer = attn_mod.Attention(cfg, device=device)
        self.norm2 = RMSNorm(d, device=device)
        if cfg.layer_has_moe(layer_idx):
            self.ffn = moe_mod.MoE(cfg, device=device)
        elif cfg.d_ff:
            self.ffn = MLP(d, cfg.d_ff, device=device)
        else:  # the mixer IS the block
            self.ffn = None

    def reset_parameters(self, generator) -> None:
        self.norm1.reset_parameters()
        self.mixer.reset_parameters(generator)
        self.norm2.reset_parameters()
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)


class Model(nn.Module):
    """Embedding, ``cfg.n_layers`` blocks, final norm and an untied head;
    float32 weights with no gradient (serving)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(Block(cfg, i, device=device) for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)
        self.head = Head(cfg.d_model, cfg.vocab_size, device=device)

    @property
    def device(self) -> torch.device:
        return self.head.w.device

    def reset_parameters(self, generator) -> None:
        self.embed.reset_parameters(generator)
        self.head.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.final_norm.reset_parameters()


def model_init(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Model:
    """A model with random weights drawn on ``device`` from a generator
    seeded with ``seed`` (the reference's draws differ: its weights come
    over through :func:`repro_torch.models.weights.from_jax_params`)."""
    device = resolve_device(device)
    model = Model(cfg, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


# ---------------------------------------------------------------------------
# forward (encoding)
# ---------------------------------------------------------------------------


def _inputs(cfg: ModelConfig, model: Model, tokens, embeds):
    dtype = act_dtype(cfg)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(dtype))
    if tokens is not None:
        parts.append(embedding_lookup(fsdp_gather(model.embed.table), tokens, dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _residual(x, h):
    """x + h, with h first laid out as the residual stream (over a mesh: the
    row-parallel products' partial sums reduced)."""
    return x + shard(h, "batch", "seq", "embed")


def _ffn(cfg: ModelConfig, layer_idx: int, blk: Block, x):
    """The block's second half: (x, MoE metrics or None)."""
    if cfg.layer_has_moe(layer_idx):
        h, metrics = moe_mod.moe_apply(cfg, blk.ffn, rmsnorm(blk.norm2.scale, x, cfg.norm_eps))
        return _residual(x, h), metrics
    if cfg.d_ff:
        return _residual(x, mlp_apply(blk.ffn, rmsnorm(blk.norm2.scale, x, cfg.norm_eps))), None
    return x, None


def _block_apply(cfg: ModelConfig, layer_idx: int, blk: Block, x, positions, aux):
    h = rmsnorm(blk.norm1.scale, x, cfg.norm_eps)
    if cfg.layer_kind(layer_idx) == "ssm":
        h = ssm_mod.mamba_forward(cfg, blk.mixer, h)
    elif cfg.use_mla:
        h = mla_mod.mla_forward(cfg, blk.mixer, h, positions)
    else:
        h = attn_mod.attn_forward(cfg, blk.mixer, h, positions)
    x, metrics = _ffn(cfg, layer_idx, blk, _residual(x, h))
    if metrics is not None:
        aux = {k: aux.get(k, 0.0) + v for k, v in metrics.items()}
    x = shard(x, "batch", "seq", "embed")
    return x, aux


# aten ops whose outputs the "dots" policy keeps: the matrix products with
# no batch dimension (``x @ w`` reaches aten.mm), as JAX's
# dots_with_no_batch_dims_saveable; bmm (einsum's batched products, the MoE
# experts) and everything elementwise are recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _period_apply(cfg: ModelConfig, model: Model, start: int, x, positions, aux):
    for i in range(start, start + cfg.block_pattern_period):
        x, aux = _block_apply(cfg, i, model.blocks[i], x, positions, aux)
    return x, aux


def _remat(policy: str, fn, *args):
    """``fn(*args)``, its activations kept (none), recomputed in the backward
    (full), or recomputed but for the saved matrix products (dots)."""
    if policy == "none":
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    fn = bound(fn)  # over a mesh, recomputed under the same context
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
            create_selective_checkpoint_contexts(_dots_policy)))
    raise ValueError(f"unknown remat policy {policy!r}")


def model_forward(
    cfg: ModelConfig,
    model: Model,
    tokens: Optional[torch.Tensor] = None,  # (B, S_text) integer
    embeds: Optional[torch.Tensor] = None,  # (B, S_front, d) modality stub
    remat: str = "none",  # none | full | dots
):
    """Returns logits (B, S, vocab) float32 and aux metrics (MoE losses).

    ``remat`` rematerialises each period of the layer pattern in the
    backward, as the reference's scanned body: the ``first_k_dense``
    prologue is never rematerialised.  It changes memory, not values.
    """
    check_matmul_precision()
    x = shard(_inputs(cfg, model, tokens, embeds), "batch", "seq", "embed")
    b, s, _ = x.shape
    positions = distribute(torch.arange(s, device=x.device).expand(b, s), "batch", "seq")
    aux = {}
    for i in range(cfg.first_k_dense):
        x, aux = _block_apply(cfg, i, model.blocks[i], x, positions, aux)
    for start in range(cfg.first_k_dense, cfg.n_layers, cfg.block_pattern_period):
        x, aux = _remat(remat, partial(_period_apply, cfg, model, start), x, positions, aux)
    x = rmsnorm(model.final_norm.scale, x, cfg.norm_eps)
    logits = shard(head_apply(model.head, x), "batch", "seq", "vocab")
    return logits, aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-layer caches
# ---------------------------------------------------------------------------


def _layer_cache_init(cfg: ModelConfig, layer_idx: int, batch: int, max_len: int, dtype, device):
    if cfg.layer_kind(layer_idx) == "ssm":
        return ssm_mod.mamba_cache_init(cfg, batch, dtype, device=device)
    if cfg.use_mla:
        return mla_mod.mla_cache_init(cfg, batch, max_len, dtype, device=device)
    return attn_mod.attn_cache_init(cfg, batch, max_len, dtype, device=device)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device) -> list:
    """One cache per layer: K/V, the MLA latent, or the Mamba conv and SSM
    states (float32), in the activation dtype otherwise."""
    dtype = act_dtype(cfg)
    return [
        _layer_cache_init(cfg, i, batch, max_len, dtype, device) for i in range(cfg.n_layers)
    ]


def _block_serve(cfg, layer_idx, blk, x, positions, cache, pos, mode):
    h = rmsnorm(blk.norm1.scale, x, cfg.norm_eps)
    if cfg.layer_kind(layer_idx) == "ssm":
        if mode == "prefill":
            h, cache = ssm_mod.mamba_prefill(cfg, blk.mixer, h)
        elif mode == "extend":
            h, cache = ssm_mod.mamba_extend(cfg, blk.mixer, h, cache)
        else:
            h, cache = ssm_mod.mamba_decode(cfg, blk.mixer, h, cache)
    elif cfg.use_mla:
        if mode == "prefill":
            h, cache = mla_mod.mla_prefill(cfg, blk.mixer, h, positions, cache)
        else:  # extend covers decode (S=1) and chunked prefill (S=chunk)
            h, cache = mla_mod.mla_extend(cfg, blk.mixer, h, cache, pos)
    else:
        if mode == "prefill":
            h, cache = attn_mod.attn_prefill(cfg, blk.mixer, h, positions, cache)
        else:
            h, cache = attn_mod.attn_extend(cfg, blk.mixer, h, cache, pos)
    x, _ = _ffn(cfg, layer_idx, blk, _residual(x, h))
    x = shard(x, "batch", "seq", "embed")
    return x, cache


def _serve_pass(cfg: ModelConfig, model: Model, x, positions, caches, pos, mode):
    """Every block over x, updating ``caches``; returns the last position's
    logits (B, vocab) (the head runs on that position alone)."""
    check_matmul_precision()
    for i, blk in enumerate(model.blocks):
        x, caches[i] = _block_serve(cfg, i, blk, x, positions, caches[i], pos, mode)
    x = rmsnorm(model.final_norm.scale, x[:, -1], cfg.norm_eps)
    return head_apply(model.head, x), caches


def model_prefill(cfg: ModelConfig, model: Model, tokens, caches, embeds=None):
    """Encode the prompt, fill caches; returns (last-position logits, caches)."""
    x = shard(_inputs(cfg, model, tokens, embeds), "batch", "seq", "embed")
    b, s, _ = x.shape
    positions = distribute(torch.arange(s, device=x.device).expand(b, s), "batch", "seq")
    return _serve_pass(cfg, model, x, positions, caches, pos=None, mode="prefill")


def model_prefill_chunked(cfg: ModelConfig, model: Model, tokens, caches, chunk: int, embeds=None):
    """Chunked (Sarathi-style) prefill: the prompt in fixed chunks, each
    extending the caches, so the working set scales with the chunk."""
    x = shard(_inputs(cfg, model, tokens, embeds), "batch", "seq", "embed")
    b, s, _ = x.shape
    if s % chunk:
        raise ValueError(f"prompt length {s} is not a multiple of the chunk {chunk}")
    logits = None
    for pos in range(0, s, chunk):
        positions = distribute(
            (pos + torch.arange(chunk, device=x.device)).expand(b, chunk), "batch", "seq"
        )
        logits, caches = _serve_pass(
            cfg, model, x[:, pos : pos + chunk], positions, caches, pos=pos, mode="extend"
        )
    return logits, caches


def model_decode(cfg: ModelConfig, model: Model, token, caches, pos: int):
    """One decode step. token: (B,) integer; pos: the absolute position."""
    x = embedding_lookup(fsdp_gather(model.embed.table), token[:, None], act_dtype(cfg))
    x = shard(x, "batch", "seq", "embed")
    positions = distribute(torch.full((x.shape[0], 1), pos, device=x.device), "batch", "seq")
    return _serve_pass(cfg, model, x, positions, caches, pos=pos, mode="decode")
