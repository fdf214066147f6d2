"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B
family; per-expert d_ff 1536]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,          # per-expert FFN width
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    moe_layer_period=1,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=96,
        vocab_size=512,
        moe_experts=8,
        moe_top_k=2,
        capacity_factor=8.0,  # no token drops: smoke tests check causal equivalence
        moe_d_ff=96,
        dtype="float32",
    )
