"""Sharded checkpoints (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (AsyncCheckpointer, restore_latest,
                                            save, save_shard)

__all__ = ["manager", "AsyncCheckpointer", "restore_latest", "save",
           "save_shard"]
