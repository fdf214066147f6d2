"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-32b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=512,
        vocab_size=512,
        dtype="float32",
    )
