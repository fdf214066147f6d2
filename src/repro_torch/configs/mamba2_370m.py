"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # no separate MLP: the mamba mixer is the whole block
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mamba2-smoke",
        n_layers=4,
        d_model=128,
        vocab_size=512,
        ssm_state=32,
        ssm_headdim=32,
        ssm_chunk=32,
        dtype="float32",
    )
