"""Step builders of the LM (the JAX package's `models/steps.py`).

`build_loss_fn` — forward and next-token loss, the eval loss of the JAX
package's launcher — and `build_serve_step` — one greedy decode step over
the KV cache — are ported.  The train step waits for the optimizer and
autograd through the reference attention (the JAX trainer runs
``attn_impl="ref"``), and raises naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from . import decode as dec
from .model import RunConfig, forward, lm_loss
from .params import NOT_PORTED_ITEM


def build_loss_fn(cfg: ModelConfig, run: RunConfig = RunConfig()):
    """loss_fn(params, batch) with batch {"tokens", "labels"} (B, S)."""

    def loss_fn(params: Dict, batch: Dict):
        logits = forward(cfg, params, batch["tokens"], run,
                         vision_embeds=batch.get("vision_embeds"))
        return lm_loss(logits, batch["labels"])

    return loss_fn


def build_train_step(cfg: ModelConfig, run: RunConfig = RunConfig()):
    raise NotImplementedError(
        f"the LM train step is not ported to PyTorch yet ({NOT_PORTED_ITEM}:"
        f" training)")


def build_serve_step(cfg: ModelConfig, run: RunConfig = RunConfig()):
    """serve_step(params, cache, tokens (B, 1)) -> (next (B,), cache): one
    batched decode step and its greedy token, in ``tokens.dtype``; the
    cache is updated in place (`decode.decode_step`)."""

    def serve_step(params: Dict, cache: Dict, tokens):
        logits, cache = dec.decode_step(cfg, params, cache, tokens, run)
        return logits.argmax(-1).to(tokens.dtype), cache

    return serve_step
