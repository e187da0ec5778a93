"""KV-cache serving path of the dense LM and the VLM backbone: the cache,
prefill, single-token decode and greedy generation (the JAX package's
`models/decode.py`, dense and VLM families).

The cache is one dict: ``k`` and ``v`` stacked over the layers, (L, B,
Hkv, Sc, hd) in the storage dtype (the model's, or f8), and ``idx``, a
0-d integer tensor on the same device that counts the tokens decoded so
far.  A sliding-window model keeps a ring of Sc = window slots.

Unlike the JAX package, which returns a new cache from every step, the
port preallocates the cache and `decode_step` writes its slot and
advances ``idx`` in place; it returns the same dict.  No call in a step
reads a device value on the host (no ``.item()``, no Python branch on a
tensor): the slot is a one-element index tensor and the valid-slot mask
is built on the device, so a step can be captured as a CUDA graph.

Decode attention is the materialised reference (`layers.attention_ref`,
non-causal over the whole cache with a valid-slot mask), as the JAX
package attends outside its Pallas kernel here whatever
``RunConfig.attn_impl`` says; prefill is sequential decode, token by
token, as in the JAX package.  MLA, MoE, RWKV, hymba and encoder-decoder
configurations raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as nn
from .model import RunConfig, _merge_heads, _norm, _qkv, _rope, ffn_branch
from .params import check_supported

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict:
    """A zeroed cache on `device` (None: the card).  dtype: the storage
    dtype of K / V only (default ``cfg.torch_dtype``; e.g.
    ``torch.float8_e4m3fn`` for an f8 cache)."""
    from ..dist.backends import resolve_device

    check_supported(cfg)
    dev = resolve_device(device)
    kv_dtype = dtype or cfg.torch_dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len(cfg, max_seq),
             cfg.hd)
    return {"idx": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}


def cache_axes(cfg: ModelConfig) -> Dict:
    """Logical sharding axes matching init_cache's structure (metadata, as
    `params` keeps its own; the port runs on one device)."""
    check_supported(cfg)
    kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    return {"idx": (), "k": kv, "v": kv}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def _write_slot(buf: Tensor, val: Tensor, slot: Tensor, axis: int) -> Tensor:
    """Write `val` (length 1 along `axis`) into `buf` in place at the
    position held by the one-element index tensor `slot`.  An f8 buffer
    is written through uint8 views (`index_copy_` has no f8 kernel)."""
    val = val.to(buf.dtype)
    if buf.dtype in nn._F8:
        buf, val = buf.view(torch.uint8), val.view(torch.uint8)
    buf.index_copy_(axis, slot, val)
    return buf


def _attn_decode(cfg: ModelConfig, h: Tensor, lp: Dict, k_cache: Tensor,
                 v_cache: Tensor, positions: Tensor, slot: Tensor,
                 kv_valid: Tensor) -> Tensor:
    """Single-token attention over one layer's (ring or full) cache, whose
    slot it writes first."""
    q, k_t, v_t = _qkv(cfg, h, lp)
    q, k_t = _rope(cfg, q, positions), _rope(cfg, k_t, positions)
    _write_slot(k_cache, k_t, slot, axis=2)
    _write_slot(v_cache, v_t, slot, axis=2)
    # attention over keys is permutation-invariant given absolute-rope'd
    # k, so the ring's order does not matter
    out = nn.attention(q, k_cache, v_cache, impl="ref", causal=False,
                       kv_valid=kv_valid)
    return _merge_heads(out) @ lp["wo"]


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, tokens: Tensor,
                run: RunConfig = RunConfig(),
                token_embeds: Optional[Tensor] = None
                ) -> Tuple[Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, V), cache).

    The cache is updated in place (its slot at ``idx`` written in every
    layer, ``idx`` advanced by one) and returned: the same dict, where
    the JAX function returns a new one.  token_embeds: optional (B, 1, D)
    embedding override (VLM vision tokens during prefill).  `run` is
    kept for the JAX signature: decode attends through the reference."""
    check_supported(cfg)
    B = tokens.shape[0]
    idx = cache["idx"]
    sc = cache["k"].shape[3]
    if token_embeds is not None:
        x = token_embeds.to(cfg.torch_dtype)
    else:
        x = params["embed"][tokens].to(cfg.torch_dtype)
    positions = idx.expand(B, 1)
    slot = (torch.remainder(idx, sc) if cfg.sliding_window > 0
            else idx).long().reshape(1)
    # slots written so far (a ring: all of them once it wrapped)
    valid = torch.arange(sc, device=idx.device) <= idx.clamp(max=sc - 1)
    kv_valid = valid.expand(B, sc)
    layer_params = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in layer_params.items()}
        h = _norm(cfg, x, lp, "norm1")
        x = x + _attn_decode(cfg, h, lp, cache["k"][i], cache["v"][i],
                             positions, slot, kv_valid)
        h = _norm(cfg, x, lp, "norm2")
        x = x + ffn_branch(cfg, h, lp)
    if cfg.norm == "ln":
        x = nn.layer_norm(x, params["final_norm"], params["final_norm_bias"])
    else:
        x = nn.rms_norm(x, params["final_norm"])
    logits = (x @ params["lm_head"].T.to(x.dtype))[:, 0]
    idx.add_(1)
    return logits, cache


# ---------------------------------------------------------------------------
# Prefill / generation
# ---------------------------------------------------------------------------
def start_cache(cfg: ModelConfig, params: Dict, batch: int, max_seq: int,
                run: RunConfig = RunConfig()) -> Dict:
    """A fresh cache on the parameters' device.  The JAX function's
    `encoder_frames` (the encoder-decoder branch) comes with whisper."""
    return init_cache(cfg, batch, max_seq, device=params["embed"].device)


def prefill(cfg: ModelConfig, params: Dict, tokens: Tensor, cache: Dict,
            run: RunConfig = RunConfig(),
            vision_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Dict]:
    """Sequential prefill: feed the prompt (B, S) token by token through
    `decode_step`.  Returns (last logits (B, V), cache), the cache updated
    in place.

    vision_embeds: optional (B, nv, D); they override the first nv token
    embeddings (VLM image tokens), as `forward` does."""
    embeds = params["embed"][tokens].to(cfg.torch_dtype)
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        embeds = torch.cat([vision_embeds.to(embeds.dtype), embeds[:, nv:]],
                           dim=1)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    run, token_embeds=embeds[:, t:t + 1])
    return logits, cache


def generate(cfg: ModelConfig, params: Dict, prompt: Tensor, n_tokens: int,
             run: RunConfig = RunConfig()) -> Tensor:
    """Greedy generation; returns (B, n_tokens) of generated ids."""
    B = prompt.shape[0]
    cache = start_cache(cfg, params, B, prompt.shape[1] + n_tokens, run)
    logits, cache = prefill(cfg, params, prompt, cache, run)
    toks = []
    for _ in range(n_tokens):
        tok = logits.argmax(-1).to(prompt.dtype)
        logits, cache = decode_step(cfg, params, cache, tok[:, None], run)
        toks.append(tok)
    return torch.stack(toks, dim=1)
