"""Step builders of the LM (the JAX package's `models/steps.py`).

`build_loss_fn` — forward and next-token loss, the eval loss of the JAX
package's launcher — is ported.  The train step waits for a backward of
the flash kernel (the JAX kernel has none either) and the optimizer; the
serve step waits for the KV-cache decode path.  Both raise naming their
ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from .model import RunConfig, forward, lm_loss
from .params import NOT_PORTED_ITEM


def build_loss_fn(cfg: ModelConfig, run: RunConfig = RunConfig()):
    """loss_fn(params, batch) with batch {"tokens", "labels"} (B, S)."""

    def loss_fn(params: Dict, batch: Dict):
        logits = forward(cfg, params, batch["tokens"], run)
        return lm_loss(logits, batch["labels"])

    return loss_fn


def build_train_step(cfg: ModelConfig, run: RunConfig = RunConfig()):
    raise NotImplementedError(
        f"the LM train step is not ported to PyTorch yet ({NOT_PORTED_ITEM}:"
        f" train, with a backward of the flash kernel)")


def build_serve_step(cfg: ModelConfig, run: RunConfig = RunConfig()):
    raise NotImplementedError(
        f"the LM serve step is not ported to PyTorch yet ({NOT_PORTED_ITEM}:"
        f" decode and serve)")
