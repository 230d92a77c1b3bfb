"""Checkpointing in the JAX package's on-disk format (see ``manager``)."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
