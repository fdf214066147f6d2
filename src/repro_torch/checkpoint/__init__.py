"""Atomic, CRC-checked checkpoints of named host arrays
(:class:`~repro_torch.checkpoint.manager.CheckpointManager`)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
