"""Checkpointing: atomic, checksummed, replicated, optionally async, on the
Young/Daly cadence, in the JAX package's on-disk layout."""
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]
