"""Assigned input-shape grid + abstract input specs (no allocation): the
port of :mod:`repro.launch.shapes`.

Every (arch x shape) cell resolves to a step kind:
  train_4k    -> train_step   (fwd+bwd+optimizer)
  prefill_32k -> serve prefill (encoder forward for encoder-only archs)
  decode_32k  -> serve decode  (one token against a full KV/state cache)
  long_500k   -> serve decode at 524288 context (sub-quadratic archs only)

Skip rules: full-attention archs skip long_500k; encoder-only archs
(hubert) skip both decode shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.kind == "decode" and not cfg.has_decode:
        return "skip(encoder-only: no decode step)"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "skip(full quadratic attention: 500k decode out of family scope)"
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input of this cell: the port's
    token ids and labels are int64, embeddings and the loss mask float32."""
    b, s = shape.global_batch, shape.seq_len
    i64 = torch.int64
    f32 = torch.float32

    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if cfg.family == "audio":
        # frame embeddings from the (stubbed) conv frontend
        if shape.kind == "train":
            return {
                "embeds": sd((b, s, cfg.d_model), f32),
                "labels": sd((b, s), i64),
            }
        if shape.kind == "prefill":
            return {"embeds": sd((b, s, cfg.d_model), f32)}
        raise ValueError("encoder-only arch has no decode inputs")

    if cfg.family == "vlm":
        nf = cfg.n_frontend_tokens
        if shape.kind == "train":
            return {
                "tokens": sd((b, s - nf), i64),
                "embeds": sd((b, nf, cfg.d_model), f32),
                "labels": sd((b, s), i64),
                "loss_mask": sd((b, s), f32),
            }
        if shape.kind == "prefill":
            return {
                "tokens": sd((b, s - nf), i64),
                "embeds": sd((b, nf, cfg.d_model), f32),
            }
        return {"token": sd((b,), i64)}

    if shape.kind == "train":
        return {"tokens": sd((b, s), i64), "labels": sd((b, s), i64)}
    if shape.kind == "prefill":
        return {"tokens": sd((b, s), i64)}
    return {"token": sd((b,), i64)}
