"""Atomic, validated checkpoints (counterpart of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
