"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # attention on layer 4 of each 8-layer block (1:7 attn:mamba)
    attn_layer_period=8,
    attn_layer_offset=4,
    # MoE every other layer, 16 experts top-2
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    # mamba mixer dims
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="jamba-smoke",
        n_layers=8,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        moe_experts=4,
        moe_top_k=2,
        capacity_factor=8.0,  # no token drops: smoke tests check causal equivalence
        moe_d_ff=256,
        ssm_state=16,
        ssm_headdim=32,
        ssm_chunk=32,
        dtype="float32",
    )
