"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="deepseek-7b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=352,
        vocab_size=512,
        dtype="float32",
    )
