"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2-1.8B backbone
[arXiv:2404.16821].  The ViT is a STUB: `input_specs` feeds precomputed
patch embeddings (B, n_frontend_tokens, d_model)."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    n_frontend_tokens=256,  # one 448x448 tile -> 256 visual tokens
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=384,
        vocab_size=512,
        n_frontend_tokens=16,
        dtype="float32",
    )
