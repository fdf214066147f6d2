"""Batched serving engine: prefill, then a greedy or temperature decode
loop (the port of :mod:`repro.serving.engine`).

The loop keeps the tokens on the model's device and the position on the
host, so no step waits for the device until the tokens are returned.
Temperature draws come from a ``torch.Generator`` seeded with
``ServeConfig.seed`` (Gumbel-max over the scaled logits): they differ from
``jax.random.categorical``'s by design; greedy tokens are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, cache_init, model_decode, model_prefill


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


def _sample(logits, temperature: float, generator: torch.Generator):
    """Greedy (the first index on ties, as ``jnp.argmax``) or a draw from
    softmax(logits / temperature) by the Gumbel-max trick."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(torch.finfo(u.dtype).tiny, 1.0)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)


def generate(
    cfg: ModelConfig,
    model: Model,
    prompt: torch.Tensor,  # (B, S_prompt) integer, on the model's device
    n_tokens: int,
    scfg: Optional[ServeConfig] = None,
    embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy/temperature generation; returns (B, n_tokens) int64 on the
    model's device.  The first token is the prefill's argmax, as in the
    reference."""
    scfg = scfg or ServeConfig()
    b, s_prompt = prompt.shape
    s_front = embeds.shape[1] if embeds is not None else 0
    device = model.device
    caches = cache_init(cfg, b, s_front + s_prompt + n_tokens, device=device)
    generator = torch.Generator(device=device).manual_seed(scfg.seed)

    logits, caches = model_prefill(cfg, model, prompt, caches, embeds=embeds)
    token = torch.argmax(logits, dim=-1)
    out = [token]
    pos = s_front + s_prompt
    for _ in range(n_tokens - 1):
        logits, caches = model_decode(cfg, model, token, caches, pos)
        token = _sample(logits, scfg.temperature, generator)
        out.append(token)
        pos += 1
    return torch.stack(out, dim=1)
