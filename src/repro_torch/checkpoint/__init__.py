"""``repro_torch.checkpoint`` — training checkpoints of the port, in the
JAX package's files (port of ``repro.checkpoint``)."""
from .checkpoint import (Checkpointer, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
