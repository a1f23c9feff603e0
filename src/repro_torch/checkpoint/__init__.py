"""Atomic, asynchronous checkpoints with retention and resume."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, gc_checkpoints, latest_step, restore_checkpoint,
    save_checkpoint)
