"""Step builders of the LM (the JAX package's `models/steps.py`).

`build_loss_fn` — forward and next-token loss — `build_train_step` — the
loss and its gradients by autograd, the global-norm clip and AdamW — and
`build_serve_step` — one greedy decode step over the KV cache.  The
trainer attends through the plain attention (`attn_impl="ref"`, or
"chunked", which is "ref" up to 1024 tokens), as the JAX trainer does:
the flash kernels, like the JAX package's, have no backward.

Each builder takes ``rules`` (`dist.sharding.ShardingRules`; default the
null rules).  Under rules bound to a DeviceMesh the parameters, the AdamW
state and the batch (`distribute_batch`) are DTensors; each gradient is
redistributed to its parameter's placements before the clip and AdamW
(the layout XLA gives the JAX step: a data-parallel gradient otherwise
stays a pending sum, and every nonlinear pass over it would reduce it
again), and the loss and grad norm come back as plain tensors, alike on
every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist import sharding
from ..dist.sharding import ShardingRules
from ..optim.adamw import AdamWState, adamw_update, clip_scale, global_norm
from ..tree import leaves, tree_map
from . import decode as dec
from .model import NULL_RULES, RunConfig, forward, lm_loss

#: The logical axes of each batch entry (the JAX package's
#: `launch/inputs.py` mapping).
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "vision_embeds": ("batch", None, "embed"),
              "encoder_frames": ("batch", "frames", "embed")}


def distribute_batch(batch: Dict, rules: ShardingRules) -> Dict:
    """The batch (full tensors, alike on every rank) laid out by `rules`
    entry by entry (`BATCH_AXES`); itself without a mesh."""
    return {k: rules.distribute(v, *BATCH_AXES[k]) for k, v in batch.items()}


def build_loss_fn(cfg: ModelConfig, run: RunConfig = RunConfig(),
                  rules: ShardingRules = NULL_RULES):
    """loss_fn(params, batch) with batch {"tokens", "labels"} (B, S), and
    "vision_embeds" (the VLM) or "encoder_frames" (whisper) where the
    config takes them.  Under a mesh the loss is a replicated DTensor."""

    def loss_fn(params: Dict, batch: Dict):
        logits = forward(cfg, params, batch["tokens"], run,
                         vision_embeds=batch.get("vision_embeds"),
                         encoder_frames=batch.get("encoder_frames"),
                         rules=rules)
        return sharding.replicate(lm_loss(logits, batch["labels"]))

    return loss_fn


def loss_and_grads(loss_fn: Callable, params: Dict,
                   batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads): the loss detached and its gradient with respect to
    every leaf of `params`, a tree of the same keys, shapes and dtypes
    (the stacked ``(L, ...)`` leaves get one gradient each); a DTensor
    leaf's gradient in the leaf's placements.  `params` is not modified
    and need not require grad."""
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        grads = iter(torch.autograd.grad(
            loss, leaves(live)))
    return loss.detach(), tree_map(
        lambda p: sharding.like(next(grads), p), live)


def build_train_step(cfg: ModelConfig, run: RunConfig = RunConfig(),
                     lr: float = 3e-4, max_grad_norm: float = 1.0,
                     weight_decay: float = 0.01,
                     rules: ShardingRules = NULL_RULES):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "step"}): the gradients by autograd, clipped to
    `max_grad_norm` by their global norm, then AdamW.  The parameters and
    the state are updated in place (`optim.adamw.adamw_update`) and
    returned.  Under a mesh every rank of it calls the step together."""
    if run.attn_impl == "flash":
        raise ValueError("the flash kernels have no backward (neither has "
                         "the JAX package's): train with attn_impl='ref'")
    loss_fn = build_loss_fn(cfg, run, rules)

    def train_step(params: Dict, opt_state: AdamWState, batch: Dict):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        gnorm = global_norm(grads)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            grad_scale=clip_scale(gnorm, max_grad_norm))
        metrics = {"loss": sharding.full(loss), "grad_norm": gnorm,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


def build_serve_step(cfg: ModelConfig, run: RunConfig = RunConfig(),
                     rules: ShardingRules = NULL_RULES):
    """serve_step(params, cache, tokens (B, 1)) -> (next (B,), cache): one
    batched decode step and its greedy token, in ``tokens.dtype``; the
    cache is updated in place (`decode.decode_step`).  Under a mesh each
    rank picks from the logits gathered over the vocab."""

    def serve_step(params: Dict, cache: Dict, tokens):
        logits, cache = dec.decode_step(cfg, params, cache, tokens, run,
                                        rules=rules)
        return sharding.unshard(logits, -1).argmax(-1).to(tokens.dtype), cache

    return serve_step
