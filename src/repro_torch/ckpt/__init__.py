"""Checkpoints of the train state in the JAX package's on-disk format."""
from .manager import Writer, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["Writer", "latest_step", "restore_checkpoint", "save_checkpoint"]
