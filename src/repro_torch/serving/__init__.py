"""Batched serving: prefill, then greedy or temperature decode."""

from repro_torch.serving.engine import ServeConfig, generate

__all__ = ["ServeConfig", "generate"]
