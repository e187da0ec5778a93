"""Atomic checkpoints of the port's trainer (the JAX package's `ckpt/`),
in the JAX package's file layout."""
from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_arrays,
    save_checkpoint,
)

__all__ = [
    "latest_checkpoint", "load_checkpoint", "restore_arrays", "save_checkpoint",
]
