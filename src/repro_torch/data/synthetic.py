"""Deterministic synthetic data pipeline: the port's copy of
:mod:`repro.data.synthetic` (numpy only, so the same Philox streams draw
the same tokens and frames bit for bit).

Replayable-by-step: ``batch_for_step(step)`` is a pure function of
(seed, step, shard), so any host can be replaced after a failure and
regenerate exactly its shard of the stream.  The token stream has learnable
low-order structure (a noisy modular-affine walk) so short training runs
show a decreasing loss.  Batches are numpy arrays; the trainer moves them
to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int  # per-host batch
    seq_len: int
    seed: int = 0
    noise: float = 0.1
    n_hosts: int = 1
    host_id: int = 0


def batch_for_step(cfg: DataConfig, step: int) -> dict:
    """Returns {"tokens": (B, S) int32, "labels": (B, S) int32}."""
    rng = np.random.Generator(
        np.random.Philox(key=[cfg.seed * 0x9E3779B1 + cfg.host_id, step])
    )
    b, s, v = cfg.batch, cfg.seq_len, cfg.vocab_size
    start = rng.integers(0, v, size=(b, 1))
    stride = rng.integers(1, min(v - 1, 7) + 1, size=(b, 1))
    seq = (start + stride * np.arange(s + 1)[None, :]) % v
    flip = rng.random((b, s + 1)) < cfg.noise
    noise_tok = rng.integers(0, v, size=(b, s + 1))
    seq = np.where(flip, noise_tok, seq).astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def frame_batch_for_step(cfg: DataConfig, step: int, d_model: int) -> dict:
    """[audio]/[vlm] stub frontend: precomputed embeddings + frame labels."""
    rng = np.random.Generator(
        np.random.Philox(key=[cfg.seed * 0x85EBCA77 + cfg.host_id, step])
    )
    b, s, v = cfg.batch, cfg.seq_len, cfg.vocab_size
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    # embeddings carry the label signal so the head can learn
    proto = rng.standard_normal((v, d_model)).astype(np.float32)
    embeds = proto[labels] + 0.5 * rng.standard_normal((b, s, d_model)).astype(
        np.float32
    )
    return {"embeds": embeds, "labels": labels}
