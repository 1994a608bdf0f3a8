"""Checkpoints of the port (counterpart of ``repro.ckpt``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
