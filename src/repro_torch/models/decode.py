"""KV-cache serving path of every family: the cache, prefill,
single-token decode and greedy generation (the JAX package's
`models/decode.py`).

The cache is one dict of tensors stacked over the layers, plus ``idx``,
a 0-d integer tensor on the same device that counts the tokens decoded
so far:

* attention: ``k`` and ``v`` (L, B, Hkv, Sc, hd) in the storage dtype
  (the model's, or f8); a sliding-window model keeps a ring of Sc =
  window slots;
* MLA: the compressed latents ``ckv`` (L, B, Sc, kv_lora_rank) and
  ``krope`` (L, B, Sc, rope_head_dim), decoded with the weight-absorbed
  scores in f32;
* RWKV6: no KV; ``wkv`` (f32), ``shift`` and ``cm_shift`` (`rwkv6`);
* hymba: the ring KV of its window plus ``ssm_h`` (f32) and
  ``conv_tail`` (`mamba`);
* whisper: ``xk`` / ``xv``, the cross-attention K / V over the encoder's
  output, filled once by `start_cache`.

Unlike the JAX package, which returns a new cache from every step, the
port preallocates the cache and `decode_step` writes its slot, copies the
new recurrent state and advances ``idx`` in place; it returns the same
dict.  No call in a step reads a device value on the host (no
``.item()``, no Python branch on a tensor, no boolean index): the slot is
a one-element index tensor and the valid-slot mask is built on the
device, so a step can be captured as a CUDA graph.

Decode attention is the materialised reference (`layers.attention_ref`,
non-causal over the whole cache with a valid-slot mask), as the JAX
package attends outside its Pallas kernel here whatever
``RunConfig.attn_impl`` says; prefill is sequential decode, token by
token, as in the JAX package.

Sharding: every function takes ``rules`` (default the null rules).  Under
rules bound to a DeviceMesh the parameters, the tokens and the cache are
DTensors, the cache laid out by `cache_pspecs` (`start_cache` does it);
the block output and the logits are constrained as in the JAX package.
The slot write (`index_copy_`, f8 through uint8 views; no DTensor rule)
runs on each rank's local shard of the cache: it writes along
``kv_seq``, which no scheme shards, after the new K / V are laid out as
the cache.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import (ShardingRules, distribute, is_dtensor, lift,
                             reshape)
from . import layers as nn
from . import mamba, rwkv6
from .model import (NULL_RULES, RunConfig, _final_norm, _merge_heads, _norm,
                    _qkv, _rope, _split_heads, embed, encode, ffn_branch)

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
    dtype of the K / V (or MLA latent) tensors only (default
    ``cfg.torch_dtype``; e.g. ``torch.float8_e4m3fn`` for an f8 cache);
    recurrent states stay at the model's precision, and wkv / ssm_h in
    f32."""
    from ..dist.backends import resolve_device

    dev = resolve_device(device)
    kv_dtype = dtype or cfg.torch_dtype
    mdt = cfg.torch_dtype
    L, hd = cfg.n_layers, cfg.hd

    def zeros(*shape, dt=kv_dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    cache: Dict = {"idx": zeros(dt=torch.int32)}
    if cfg.mixer == "rwkv6":
        cache.update(rwkv6.init_state(cfg, batch, mdt, dev))
        return cache
    sc = cache_len(cfg, max_seq)
    if cfg.mixer == "mla":
        cache["ckv"] = zeros(L, batch, sc, cfg.kv_lora_rank)
        cache["krope"] = zeros(L, batch, sc, cfg.rope_head_dim)
    else:
        cache["k"] = zeros(L, batch, cfg.n_kv_heads, sc, hd)
        cache["v"] = zeros(L, batch, cfg.n_kv_heads, sc, hd)
    if cfg.mixer == "hymba":
        cache.update(mamba.init_state(cfg, batch, mdt, dev))
    if cfg.is_encoder_decoder:
        cache["xk"] = zeros(L, batch, cfg.n_kv_heads, cfg.encoder_seq, hd)
        cache["xv"] = zeros(L, batch, cfg.n_kv_heads, cfg.encoder_seq, hd)
    return cache


def cache_axes(cfg: ModelConfig) -> Dict:
    """Logical sharding axes matching init_cache's structure."""
    ax: Dict = {"idx": ()}
    if cfg.mixer == "rwkv6":
        ax.update({
            "wkv": ("layers", "batch", "heads", None, None),
            "shift": ("layers", "batch", "embed"),
            "cm_shift": ("layers", "batch", "embed"),
        })
        return ax
    if cfg.mixer == "mla":
        ax["ckv"] = ("layers", "batch", "kv_seq", "kv_lora")
        ax["krope"] = ("layers", "batch", "kv_seq", None)
    else:
        ax["k"] = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
        ax["v"] = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    if cfg.mixer == "hymba":
        ax["ssm_h"] = ("layers", "batch", "ffn", "state")
        ax["conv_tail"] = ("layers", "batch", None, "ffn")
    if cfg.is_encoder_decoder:
        ax["xk"] = ("layers", "batch", "kv_heads", "frames", "head_dim")
        ax["xv"] = ("layers", "batch", "kv_heads", "frames", "head_dim")
    return ax


def cache_pspecs(cfg: ModelConfig, rules: ShardingRules) -> Dict:
    """The PartitionSpec of every cache entry under `rules`."""
    return {k: rules.spec(*axes) for k, axes in cache_axes(cfg).items()}


def distribute_cache(cfg: ModelConfig, cache: Dict,
                     rules: ShardingRules) -> Dict:
    """`cache` (full tensors, alike on every rank) as DTensors laid out by
    `cache_pspecs`; itself without a mesh."""
    if rules.mesh is None:
        return cache
    specs = cache_pspecs(cfg, rules)
    return {k: distribute(t, rules.mesh, specs[k]) for k, t in cache.items()}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def _write_slot(buf: Tensor, val: Tensor, slot: Tensor, axis: int) -> Tensor:
    """Write `val` (length 1 along `axis`) into `buf` in place at the
    position held by the one-element index tensor `slot`.  An f8 buffer
    is written through uint8 views (`index_copy_` has no f8 kernel).  A
    DTensor buffer is written on its local shard, `val` first laid out
    as the buffer (`axis` is never sharded)."""
    val = val.to(buf.dtype)
    if is_dtensor(buf):
        val = val.redistribute(buf.device_mesh, buf.placements).to_local()
        buf, slot = buf.to_local(), slot.to_local()
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
    if not cfg.is_encoder_decoder:
        q, k_t = _rope(cfg, q, positions), _rope(cfg, k_t, positions)
    _write_slot(k_cache, k_t, slot, axis=2)
    _write_slot(v_cache, v_t, slot, axis=2)
    # attention over keys is permutation-invariant given absolute-rope'd
    # k, so the ring's order does not matter
    out = nn.attention(q, k_cache, v_cache, impl="ref", causal=False,
                       kv_valid=kv_valid)
    return _merge_heads(out) @ lp["wo"]


def _mla_decode(cfg: ModelConfig, h: Tensor, lp: Dict, ckv: Tensor,
                krope: Tensor, positions: Tensor, slot: Tensor,
                valid: Tensor) -> Tensor:
    """Single-token MLA over one layer's latent cache, whose slot it
    writes first: the weight-absorbed scores q_nope W_uk^T c_kv plus the
    RoPE part, softmax and the context through W_uv, all in f32."""
    b = h.shape[0]
    hq, hd, rd, r_kv = (cfg.n_heads, cfg.hd, cfg.rope_head_dim,
                        cfg.kv_lora_rank)
    cq = nn.rms_norm(h @ lp["wdq"], lp["q_norm"])
    q_nope = _split_heads(cq @ lp["wuq"], hq)[:, :, 0]          # (B,H,hd)
    q_rope = nn.apply_rope(_split_heads(cq @ lp["wq_rope"], hq), positions,
                           cfg.rope_theta)[:, :, 0]             # (B,H,rd)
    ckv_t = nn.rms_norm(h @ lp["wdkv"], lp["kv_norm"])          # (B,1,r_kv)
    krope_t = nn.apply_rope(_split_heads(h @ lp["wk_rope"], 1), positions,
                            cfg.rope_theta)[:, 0]               # (B,1,rd)
    _write_slot(ckv, ckv_t, slot, axis=1)
    _write_slot(krope, krope_t, slot, axis=1)
    wuk = lp["wuk"].reshape(r_kv, hq, hd).float()
    wuv = lp["wuv"].reshape(r_kv, hq, hd).float()
    ckv32 = ckv.float()
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope.float(), wuk)
    s = torch.einsum("bhr,bsr->bhs", q_abs, ckv32)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope.float(), krope.float())
    s = s / math.sqrt(hd + rd)
    s = torch.where(valid[None, None, :], s, torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr, ckv32)
    out = torch.einsum("bhr,rhd->bhd", ctx, wuv)
    return reshape(out, (b, 1, hq * hd)).to(h.dtype) @ lp["wo"]


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, tokens: Tensor,
                run: RunConfig = RunConfig(),
                token_embeds: Optional[Tensor] = None,
                rules: ShardingRules = NULL_RULES
                ) -> Tuple[Tensor, Dict]:
    """tokens (B, 1) -> (logits (B, V), cache).

    The cache is updated in place (every layer's slot at ``idx`` written,
    its recurrent state replaced, ``idx`` advanced by one) and returned:
    the same dict, where the JAX function returns a new one.
    token_embeds: optional (B, 1, D) embedding override (VLM vision
    tokens during prefill).  `run` steers the FFN (the MoE levers);
    decode attends through the reference."""
    B = tokens.shape[0]
    idx = cache["idx"]
    if token_embeds is not None:
        x = token_embeds.to(cfg.torch_dtype)
    else:
        x = embed(params, tokens).to(cfg.torch_dtype)
    positions = idx.expand(B, 1)
    if cfg.is_encoder_decoder:
        x = x + nn.sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    kv = "ckv" if cfg.mixer == "mla" else "k"
    if kv in cache:
        sc = cache[kv].shape[2 if kv == "ckv" else 3]
        slot = (torch.remainder(idx, sc) if cfg.sliding_window > 0
                else idx).long().reshape(1)
        # slots written so far (a ring: all of them once it wrapped)
        valid = (lift(torch.arange(sc, device=idx.device), idx)
                 <= idx.clamp(max=sc - 1))
    layer_params = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in layer_params.items()}
        h = _norm(cfg, x, lp, "norm1")
        if cfg.mixer == "rwkv6":
            y, (wkv, shift) = rwkv6.time_mix(
                h, lp, (cache["wkv"][i], cache["shift"][i]), cfg.n_heads)
            cache["wkv"][i].copy_(wkv)
            cache["shift"][i].copy_(shift)
            x = x + y
            y, cm_shift = rwkv6.channel_mix(_norm(cfg, x, lp, "norm2"), lp,
                                            cache["cm_shift"][i])
            cache["cm_shift"][i].copy_(cm_shift)
            x = x + y
            continue
        if cfg.mixer == "mla":
            y = _mla_decode(cfg, h, lp, cache["ckv"][i], cache["krope"][i],
                            positions, slot, valid)
        else:
            y = _attn_decode(cfg, h, lp, cache["k"][i], cache["v"][i],
                             positions, slot, valid.expand(B, sc))
        if cfg.mixer == "hymba":
            y_ssm, (ssm_h, conv_tail) = mamba.ssm_branch(
                h, lp, (cache["ssm_h"][i], cache["conv_tail"][i]),
                cfg.ssm_state)
            cache["ssm_h"][i].copy_(ssm_h)
            cache["conv_tail"][i].copy_(conv_tail)
            y = 0.5 * (y + y_ssm)
        x = x + y
        if cfg.is_encoder_decoder:
            h = _norm(cfg, x, lp, "norm3")
            q = h @ lp["wq_x"]
            if cfg.qkv_bias:
                q = q + lp["bq_x"]
            out = nn.attention(_split_heads(q, cfg.n_heads), cache["xk"][i],
                               cache["xv"][i], impl="ref", causal=False)
            x = x + _merge_heads(out) @ lp["wo_x"]
        x = x + ffn_branch(cfg, _norm(cfg, x, lp, "norm2"), lp, run, rules)
        x = rules.constrain(x, "batch", None, "embed")
    x = _final_norm(cfg, x, params)
    logits = (x @ params["lm_head"].T.to(x.dtype))[:, 0]
    idx.add_(1)
    return rules.constrain(logits, "batch", "vocab"), cache


# ---------------------------------------------------------------------------
# Prefill / generation
# ---------------------------------------------------------------------------
def start_cache(cfg: ModelConfig, params: Dict, batch: int, max_seq: int,
                run: RunConfig = RunConfig(),
                encoder_frames: Optional[Tensor] = None,
                rules: ShardingRules = NULL_RULES) -> Dict:
    """A fresh cache on the parameters' device, laid out by
    `cache_pspecs` under a mesh; for the encoder-decoder also runs the
    encoder over `encoder_frames` (B, enc_seq, D) and fills every layer's
    cross-attention K / V."""
    cache = distribute_cache(cfg, init_cache(
        cfg, batch, max_seq, device=params["embed"].device), rules)
    if cfg.is_encoder_decoder:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name} needs encoder frames")
        enc_out = encode(cfg, params, encoder_frames, run, rules)
        lw = params["layers"]
        for i in range(cfg.n_layers):       # the forward's cross K / V
            for name in ("k", "v"):
                y = enc_out @ lw[f"w{name}_x"][i]
                if cfg.qkv_bias:
                    y = y + lw[f"b{name}_x"][i]
                cache[f"x{name}"][i].copy_(_split_heads(y, cfg.n_kv_heads))
    return cache


def prefill(cfg: ModelConfig, params: Dict, tokens: Tensor, cache: Dict,
            run: RunConfig = RunConfig(),
            vision_embeds: Optional[Tensor] = None,
            rules: ShardingRules = NULL_RULES) -> Tuple[Tensor, Dict]:
    """Sequential prefill: feed the prompt (B, S) token by token through
    `decode_step`.  Returns (last logits (B, V), cache), the cache updated
    in place.

    vision_embeds: optional (B, nv, D); they override the first nv token
    embeddings (VLM image tokens), as `forward` does."""
    embeds = embed(params, tokens).to(cfg.torch_dtype)
    if vision_embeds is not None:
        nv = vision_embeds.shape[1]
        embeds = torch.cat([vision_embeds.to(embeds.dtype), embeds[:, nv:]],
                           dim=1)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    run, token_embeds=embeds[:, t:t + 1],
                                    rules=rules)
    return logits, cache


def generate(cfg: ModelConfig, params: Dict, prompt: Tensor, n_tokens: int,
             run: RunConfig = RunConfig(),
             encoder_frames: Optional[Tensor] = None,
             rules: ShardingRules = NULL_RULES) -> Tensor:
    """Greedy generation; returns (B, n_tokens) of generated ids."""
    B = prompt.shape[0]
    cache = start_cache(cfg, params, B, prompt.shape[1] + n_tokens, run,
                        encoder_frames, rules)
    logits, cache = prefill(cfg, params, prompt, cache, run, rules=rules)
    toks = []
    for _ in range(n_tokens):
        tok = logits.argmax(-1).to(prompt.dtype)
        logits, cache = decode_step(cfg, params, cache, tok[:, None], run,
                                    rules=rules)
        toks.append(tok)
    return torch.stack(toks, dim=1)
