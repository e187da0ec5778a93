"""The optimizer of the port's trainer (the JAX package's `optim/`)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm"]
