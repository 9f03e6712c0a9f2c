from .ckpt import (CheckpointManager, latest_step, load_checkpoint,
                   reshard_tree, save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "reshard_tree", "save_checkpoint"]
