from repro_torch.checkpoint.store import (CheckpointManager,
                                          restore_resharded,
                                          save_checkpoint, load_checkpoint)

__all__ = ["CheckpointManager", "restore_resharded", "save_checkpoint",
           "load_checkpoint"]
