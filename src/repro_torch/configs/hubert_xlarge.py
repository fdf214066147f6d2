"""hubert-xlarge [audio] — encoder-only transformer backbone
[arXiv:2106.07447].  The conv feature extractor is a STUB: `input_specs`
feeds precomputed frame embeddings (B, S, d_model); the head predicts the
504-unit cluster vocabulary per frame."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,       # encoder-only: bidirectional, no decode step
    frontend="audio",
    n_frontend_tokens=-1,  # the whole sequence comes from the frontend
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="hubert-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=384,
        vocab_size=64,
        dtype="float32",
    )
