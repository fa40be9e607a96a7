"""Checkpointing (port of ``repro/checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointManager, load_checkpoint, save_checkpoint,
                                            tree_to_flat)

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint", "tree_to_flat"]
