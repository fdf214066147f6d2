"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,       # nemo uses head_dim 128 (not d_model/n_heads = 160)
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mistral-nemo-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=384,
        vocab_size=512,
        dtype="float32",
    )
