"""Deterministic synthetic data: the token and frame streams."""

from repro_torch.data.synthetic import DataConfig, batch_for_step, frame_batch_for_step

__all__ = ["DataConfig", "batch_for_step", "frame_batch_for_step"]
