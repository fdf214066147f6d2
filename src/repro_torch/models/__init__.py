"""The LM substrate's models (the port of :mod:`repro.models`): the 10
architecture families as float32-weight modules with bf16 or float32
activations, and their serve paths."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    cache_init,
    model_decode,
    model_forward,
    model_init,
    model_prefill,
)

__all__ = [
    "ModelConfig",
    "cache_init",
    "model_decode",
    "model_forward",
    "model_init",
    "model_prefill",
]
