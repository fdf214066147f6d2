"""Mamba-2 mixer via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060]: the port of :mod:`repro.models.mamba2`.

Prefill runs the chunked SSD form: the quadratic dual within each chunk,
then a sequential state recurrence over the chunks.  Decode is the O(1)
recurrent step on the (B, H, P, N) state.  The reference's three-operand
einsums are contracted here in two explicit steps, so no intermediate
larger than the (B, nc, Q, Q, H) decay block is formed.
"""

from __future__ import annotations

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
from repro_torch.models.layers import RMSNorm, param, rmsnorm, truncated_normal_


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        cd = _conv_dim(cfg)
        self.in_proj = param(d, 2 * di + 2 * ns + nh, device=device)  # z, x, B, C, dt
        self.conv_w = param(cfg.ssm_conv, cd, device=device)
        self.conv_b = param(cd, device=device)
        self.a_log = param(nh, device=device)
        self.d_skip = param(nh, device=device)
        self.dt_bias = param(nh, device=device)
        self.gate_norm = RMSNorm(di, device=device)
        self.out_proj = param(di, d, device=device)

    def reset_parameters(self, generator) -> None:
        truncated_normal_(self.in_proj, 1.0, generator)
        with torch.no_grad():
            self.conv_w.normal_(generator=generator).mul_(0.1)
            self.conv_b.zero_()
            nh = self.a_log.shape[0]
            self.a_log.copy_(torch.log(torch.arange(1, nh + 1, dtype=torch.float32)))
            self.d_skip.fill_(1.0)
            self.dt_bias.zero_()
        self.gate_norm.reset_parameters()
        truncated_normal_(self.out_proj, 1.0, generator)


def _split_proj(cfg: ModelConfig, proj):
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return proj.split([di, di + 2 * ns, nh], dim=-1)  # z, xbc, dt


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _causal_conv(mamba: Mamba2, xbc, conv_state=None):
    """Depthwise causal conv over the (B, L, conv_dim) channel block.

    conv_state: (B, K-1, conv_dim) holding the previous inputs (decode).
    Returns (out, new_conv_state).  Over a mesh, on each rank's channels.
    """
    ctx = current_ctx()
    if ctx is None or layout_of(xbc) is None:
        return _conv(mamba.conv_w, mamba.conv_b, xbc, conv_state)
    lx = ctx.layout(xbc.shape, ("batch", None, "ssm_inner"))
    lw = ctx.layout(mamba.conv_w.shape, (None, "ssm_inner"))
    lb = ctx.layout(mamba.conv_b.shape, ("ssm_inner",))
    ls = None if conv_state is None else lx
    batch_axes = sharded_axes(lx, ctx, 0)
    return local(_conv, (lx, lx), (lw, lb, lx, ls), summed=(batch_axes, batch_axes, None, None))(
        mamba.conv_w, mamba.conv_b, xbc, conv_state
    )


def _conv(conv_w, conv_b, xbc, conv_state):
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # (B, L + K - 1, cd)
    w = conv_w.to(xbc.dtype)
    length = xbc.shape[1]
    out = sum(full[:, i : i + length, :] * w[i] for i in range(k))
    out = F.silu(out + conv_b.to(xbc.dtype))
    new_state = full[:, -(k - 1) :, :]
    return out, new_state


def _ssd(cfg: ModelConfig, x, dt, b_mat, c_mat, a, initial_state=None):
    """:func:`_ssd_chunked`; over a mesh, on each rank's heads (the scan is
    independent per head; B and C are shared by every head)."""
    ctx = current_ctx()
    if ctx is None or layout_of(x) is None:
        return _ssd_chunked(cfg, x, dt, b_mat, c_mat, a, initial_state)
    lx = ctx.layout(x.shape, ("batch", "seq", "ssm_heads", None))
    lh = ctx.layout(dt.shape, ("batch", "seq", "ssm_heads"))
    lbc = ctx.layout(b_mat.shape, ("batch", "seq", None))
    lst = ctx.layout((x.shape[0], x.shape[2], x.shape[3], b_mat.shape[2]),
                     ("batch", "ssm_heads", None, None))
    ls = None if initial_state is None else lst
    heads = sharded_axes(lx, ctx, 2)  # B and C are shared by every head
    return local(_ssd_chunked, (lx, lst), (None, lx, lh, lbc, lbc, lh, ls),
                 summed=(None, None, None, heads, heads, None, None))(
        cfg, x, dt, b_mat, c_mat, a, initial_state
    )


def _ssd_chunked(cfg: ModelConfig, x, dt, b_mat, c_mat, a, initial_state=None):
    """Chunked SSD scan.

    x: (B, L, H, P) the post-conv branch by heads; dt: (B, L, H) positive
    step sizes; a: (B, L, H) = A*dt (negative); b_mat/c_mat: (B, L, N)
    shared across heads.  Returns (y (B, L, H, P), final_state (B, H, P, N)).
    """
    B, L, H, P = x.shape
    N = b_mat.shape[-1]
    Q = min(cfg.ssm_chunk, L)
    orig_len = L
    if L % Q:
        # pad the tail: a=0 (decay 1) and x=0 leave the recurrent state exact
        pad = Q - L % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        L = L + pad
    nc = L // Q

    xe = (x * dt[..., None]).float().reshape(B, nc, Q, H, P)
    xe = shard(xe, "batch", None, None, "ssm_heads", None)
    a = a.float().reshape(B, nc, Q, H)
    bm = b_mat.float().reshape(B, nc, Q, N)
    cm = c_mat.float().reshape(B, nc, Q, N)

    a_cs = torch.cumsum(a, dim=2)  # inclusive within-chunk cumsum
    # intra-chunk (dual quadratic form): L[i, j] = exp(a_cs[i] - a_cs[j]), i >= j
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    # mask BEFORE exp: the upper triangle's exp overflows, and inf * 0 is NaN
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    decay = shard(decay, "batch", None, None, None, "ssm_heads")
    scores = torch.einsum("bcin,bcjn->bcij", cm, bm)  # (B,nc,Q,Q)
    # "bcij,bcijh,bcjhp->bcihp" in two steps
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xe)

    # per-chunk end states: sum_j B_j (x_j dt_j) exp(a_cs[-1] - a_cs[j])
    end_decay = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (B,nc,Q,H)
    # "bcjn,bcjh,bcjhp->bchpn" in two steps
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", bm, xe * end_decay[..., None])

    # inter-chunk recurrence
    chunk_decay = torch.exp(a.sum(dim=2))  # (B,nc,H)
    if initial_state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    else:
        state = initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: C_i (state at chunk start) decayed to i;
    # "bcin,bchpn,bcih->bcihp" in two steps
    in_decay = torch.exp(a_cs)  # (B,nc,Q,H)
    y_off = torch.einsum("bcin,bchpn->bcihp", cm, prev_states) * in_decay[..., None]

    y = (y_diag + y_off).reshape(B, L, H, P)
    return y[:, :orig_len], state


def mamba_forward(cfg: ModelConfig, mamba: Mamba2, x):
    y, _ = _mamba_seq(cfg, mamba, x, conv_state=None, ssm_state=None)
    return y


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, *, device):
    return {
        "ssm": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
            dtype=torch.float32, device=device,
        ),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dtype=dtype, device=device),
    }


def mamba_prefill(cfg: ModelConfig, mamba: Mamba2, x):
    """Prefill starts from a zero state, whatever the layer's cache holds."""
    return _mamba_seq(cfg, mamba, x, conv_state=None, ssm_state=None)


def mamba_extend(cfg: ModelConfig, mamba: Mamba2, x, cache):
    """Chunked prefill / multi-token decode: carry conv+ssm state forward."""
    return _mamba_seq(cfg, mamba, x, conv_state=cache["conv"], ssm_state=cache["ssm"])


def _mamba_seq(cfg: ModelConfig, mamba: Mamba2, x, conv_state, ssm_state):
    b, l, _ = x.shape
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    dtype = x.dtype
    proj = x @ fsdp_gather(mamba.in_proj.to(dtype))
    z, xbc, dt_raw = _split_proj(cfg, shard(proj, "batch", "seq", None))
    xbc, new_conv = _causal_conv(mamba, xbc, conv_state)
    xs, b_mat, c_mat = xbc.split([di, ns, ns], dim=-1)

    dt = _softplus(dt_raw.float() + mamba.dt_bias)  # (B,L,H)
    dt = shard(dt, "batch", "seq", "ssm_heads")
    a = -torch.exp(mamba.a_log)[None, None, :] * dt  # (B,L,H)
    xh = xs.reshape(b, l, nh, hp)
    xh = shard(xh, "batch", "seq", "ssm_heads", None)
    y, final_state = _ssd(cfg, xh, dt, b_mat, c_mat, a, ssm_state)
    y = shard(y, "batch", "seq", "ssm_heads", None)
    y = y.to(dtype) + mamba.d_skip.to(dtype)[None, None, :, None] * xh
    y = y.reshape(b, l, di)
    y = rmsnorm(mamba.gate_norm.scale, y * F.silu(z), cfg.norm_eps)
    out = y @ fsdp_gather(mamba.out_proj.to(dtype))
    return out, {"ssm": final_state, "conv": new_conv}


def mamba_decode(cfg: ModelConfig, mamba: Mamba2, x, cache):
    """One-token recurrent step. x: (B, 1, d_model)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba_decode takes one token, got {s}")
    di, ns, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    dtype = x.dtype
    proj = x @ fsdp_gather(mamba.in_proj.to(dtype))
    z, xbc, dt_raw = _split_proj(cfg, shard(proj, "batch", "seq", None))
    xbc, new_conv = _causal_conv(mamba, xbc, cache["conv"])
    xs, b_mat, c_mat = xbc.split([di, ns, ns], dim=-1)

    dt = _softplus(dt_raw.float() + mamba.dt_bias)[:, 0]  # (B,H)
    ga = torch.exp(-torch.exp(mamba.a_log)[None, :] * dt)  # (B,H)
    xh = xs.reshape(b, nh, hp).float()
    bm = b_mat[:, 0].float()  # (B,N)
    cm = c_mat[:, 0].float()
    state = cache["ssm"] * ga[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh * dt[:, :, None], bm
    )
    y = torch.einsum("bhpn,bn->bhp", state, cm)
    y = y.to(dtype) + mamba.d_skip.to(dtype)[None, :, None] * xh.to(dtype)
    y = y.reshape(b, 1, di)
    y = rmsnorm(mamba.gate_norm.scale, y * F.silu(z), cfg.norm_eps)
    out = y @ fsdp_gather(mamba.out_proj.to(dtype))
    return out, {"ssm": state, "conv": new_conv}
