"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,     # MLA: logical heads (cache is latent, shared)
    d_ff=12288,         # dense FFN width (first layer)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe_experts=160,
    moe_top_k=6,
    moe_d_ff=1536,
    moe_shared_experts=2,
    moe_layer_period=1,
    first_k_dense=1,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="deepseek-v2-smoke",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_rope_head_dim=16,
        qk_nope_head_dim=32,
        v_head_dim=32,
        moe_experts=8,
        moe_top_k=2,
        capacity_factor=8.0,  # no token drops: smoke tests check causal equivalence
        moe_d_ff=64,
        moe_shared_experts=1,
        first_k_dense=1,
        dtype="float32",
    )
