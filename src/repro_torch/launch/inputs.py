"""Meta-tensor input stand-ins for every (arch x shape) cell (the JAX
package's `launch/inputs.py`).

`input_specs` returns meta tensors of the cell's shapes and dtypes (no
memory): token batches for train / prefill, token + KV-cache trees for
decode, and their `PartitionSpec`s under a rules object.  Modality
frontends are stubs, as in the JAX package: whisper gets precomputed
frame embeddings, qwen2-vl gets patch embeddings."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..dist.sharding import ShardingRules
from ..models import decode as dec
from ..models.steps import BATCH_AXES

Tensor = torch.Tensor


def _meta(shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.torch_dtype
    specs = {
        "tokens": _meta((B, S), torch.int32),
        "labels": _meta((B, S), torch.int32),
    }
    if cfg.family == "vlm":
        specs["vision_embeds"] = _meta((B, cfg.n_vision_tokens, cfg.d_model),
                                       dt)
    if cfg.is_encoder_decoder:
        specs["encoder_frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                        dt)
    return specs


def batch_pspecs(cfg: ModelConfig, rules: ShardingRules) -> Dict:
    """The spec of each entry of `batch_specs`, from `steps.BATCH_AXES`."""
    keys = ["tokens", "labels"]
    if cfg.family == "vlm":
        keys.append("vision_embeds")
    if cfg.is_encoder_decoder:
        keys.append("encoder_frames")
    return {k: rules.spec(*BATCH_AXES[k]) for k in keys}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec,
                 kv_dtype=None) -> Tuple[Dict, Tensor]:
    """(cache of meta tensors, tokens (B, 1)); kv_dtype: the K / V (or MLA
    latent) storage dtype, e.g. ``torch.float8_e4m3fn``."""
    B, S = shape.global_batch, shape.seq_len
    cache = dec.init_cache(cfg, B, S, dtype=kv_dtype, device="meta")
    return cache, _meta((B, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, kv_dtype=None) -> Dict:
    """All model inputs for a cell, keyed by step-function argument."""
    if shape.is_decode:
        cache, tokens = decode_specs(cfg, shape, kv_dtype)
        return {"cache": cache, "tokens": tokens}
    return {"batch": batch_specs(cfg, shape)}
