"""Checkpointing of the port (the JAX package's on-disk layout)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
