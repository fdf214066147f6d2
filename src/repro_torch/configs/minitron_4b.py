"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="minitron-4b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=288,
        vocab_size=512,
        dtype="float32",
    )
