"""The LM of every family: full-sequence forward and loss (the JAX
package's `models/model.py`).

Layers run as a Python loop over the stacked ``(L, ...)`` parameters (the
JAX package scans them).  The mixer of a block follows the config: GQA
attention, MLA (`mla_branch`), RWKV6 (`rwkv6.time_mix`, with its channel
mix in place of the FFN) or hymba's attention over a sliding window in
parallel with the mamba branch; the FFN is dense (SwiGLU or GELU) or MoE
(`moe`, with shared experts).  Whisper adds an encoder stack (`encode`),
sinusoidal positions instead of RoPE, and cross-attention over the
encoder's output in every decoder layer.

With ``RunConfig(attn_impl="flash")`` every attention whose q and v head
dims agree and that has no window is one launch of the flash kernel:
GQA, whisper's encoder (non-causal), decoder (causal) and cross-attention
(non-causal, Sq != Sk); MLA (q 192 wide, v 128) and hymba (a window) take
the chunked path, as in the JAX package.

Sharding: every function takes ``rules`` (`dist.sharding.ShardingRules`,
default the null rules, a no-op).  Under rules bound to a DeviceMesh the
parameters and the batch are DTensors, and the JAX package's sharding
constraints become ``rules.constrain`` (a ``redistribute``) at its
points: the embedded input, q / k / v (``RunConfig.qkv_constraints``),
the SwiGLU hidden, each block's output, each encoder block's output and
the logits.  The KV-cache decode path is `models.decode`.

Rematerialisation (`RunConfig.remat`, the JAX package's `_maybe_remat`):
every decoder block, and every block of whisper's encoder, runs under
non-reentrant `torch.utils.checkpoint`, which keeps what the mode saves
and recomputes the rest of the block in the backward:

* ``none``: autograd keeps what it keeps (no checkpoint);
* ``full``: nothing inside the block (JAX ``nothing_saveable``);
* ``dots``: the outputs of products with no batch dims (JAX
  ``checkpoint_dots_with_no_batch_dims``).  A ``(B, S, D) @ (D, F)``
  product lowers to ``aten.mm`` (``aten.addmm`` with a fused bias): the
  projections, the router and the shared experts, MLA's down- and
  up-projections, RWKV's and mamba's projections, which JAX writes as
  dot_generals without batch dims.  Attention's einsums, the MoE
  experts' products, RWKV's per-step wkv and mamba's per-step readout
  lower to ``aten.bmm`` and are recomputed, as JAX recomputes their
  batched dot_generals;
* ``named``: only the two branch outputs JAX tags ``mix_out`` (the
  mixer's output; not RWKV's, which JAX does not tag) and ``ffn_out``.
  Torch has no ``checkpoint_name``: `_tag` copies the tensor once
  (``aten.clone``) while a module flag names it, and the policy saves
  exactly those copies.  Under a mesh the copy of a pending-sum DTensor
  changes how DTensor lays out its gradient, so the sums of the
  backward run in another order (within rounding of ``none``).

``attn_remat`` checkpoints the attention call of `attn_branch` and
`mla_branch` (the `local_map` of a sharded call included), saving
nothing inside it.  ``unroll_layers`` is accepted and recorded and
changes nothing: the layers already run as a Python loop, which the JAX
package gets by unrolling its scan.  Under every mode the loss and the
gradients are the bits of ``none`` (``named`` under a mesh: above).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import (ShardingRules, is_dtensor, lift, reshape,
                             shard_range)
from . import layers as nn
from . import mamba, moe, rwkv6

Tensor = torch.Tensor

#: The rules of an unsharded call: every constraint is the identity.
NULL_RULES = ShardingRules.null()


#: The values of `RunConfig.remat`.
REMAT_MODES = ("none", "full", "dots", "named")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Attention, remat, MoE and sharding levers of the forward (the JAX
    package's fields, in its order)."""

    attn_impl: str = "chunked"      # ref | chunked | flash
    attn_chunk: int = 1024
    remat: str = "none"             # none | full | dots | named
    scheme: str = "default"         # sharding scheme (dist/sharding.py)
    moe_capacity_factor: Optional[float] = None  # overrides the config's
    # recompute the attention call in the backward (saves nothing of it)
    attn_remat: bool = False
    # constrain q / k / v to their head sharding (else propagate)
    qkv_constraints: bool = True
    # 'global_sort' (one sort of all assignments) or 'grouped' (a sort per
    # group of tokens)
    moe_dispatch: str = "global_sort"
    moe_groups: int = 1
    # the JAX package unrolls its layer scan with it; the port's layers
    # are a Python loop already, so it changes nothing here
    unroll_layers: bool = False

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT_MODES}")


#: The name `_tag` is tagging while it copies (read by `_save_named`).
_TAGGING = [None]


def _tag(x: Tensor, name: str, run: RunConfig) -> Tensor:
    """x under remat "named": a copy that the policy saves (the JAX
    ``checkpoint_name(x, name)``); x itself under every other mode."""
    if run.remat != "named":
        return x
    _TAGGING[0] = name
    try:
        return x.clone()
    finally:
        _TAGGING[0] = None


def _save_dots(ctx, op, *args, **kwargs):
    """Save the products with no batch dims, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_named(ctx, op, *args, **kwargs):
    """Save the copies `_tag` makes, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.clone.default and _TAGGING[0] is not None:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: The selective policy of each remat mode that keeps something.
POLICIES = {"dots": _save_dots, "named": _save_named}


def _checkpointed(fn: Callable, policy: Optional[Callable] = None):
    """fn under non-reentrant checkpoint: `policy` picks what is saved
    (None: nothing)."""
    from torch.utils import checkpoint as ckpt

    def run(*args):
        kw = {}
        if policy is not None:
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, policy)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _maybe_remat(fn: Callable, run: RunConfig) -> Callable:
    """fn (a block) under `run.remat` (the JAX `_maybe_remat`)."""
    if run.remat == "none":
        return fn
    if run.remat == "full":
        return _checkpointed(fn)
    return _checkpointed(fn, POLICIES[run.remat])


def _attend(run: RunConfig, q: Tensor, k: Tensor, v: Tensor,
            **kw) -> Tensor:
    """`nn.attention` of q, k, v, checkpointed under ``attn_remat``."""
    attn = functools.partial(nn.attention, impl=run.attn_impl,
                             chunk=run.attn_chunk, **kw)
    if run.attn_remat:
        attn = _checkpointed(attn)
    return attn(q, k, v)


def _norm(cfg: ModelConfig, x: Tensor, p: Dict, name: str) -> Tensor:
    if cfg.norm == "ln":
        return nn.layer_norm(x, p[name], p[name + "_bias"])
    return nn.rms_norm(x, p[name])


def _split_heads(x: Tensor, n_heads: int) -> Tensor:
    b, s, d = x.shape
    return reshape(x, (b, s, n_heads, d // n_heads)).transpose(1, 2)


def _merge_heads(x: Tensor) -> Tensor:
    b, h, s, d = x.shape
    return reshape(x.transpose(1, 2), (b, s, h * d))


def _qkv(cfg: ModelConfig, x: Tensor, p: Dict,
         kv_src: Optional[Tensor] = None, sfx: str = ""):
    """q, k, v as (B, H, S, hd) head views: the fused QKV projection of
    x, or (``sfx="_x"``, cross-attention) separate projections of q from
    x and of k and v from `kv_src`."""
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if sfx == "":
        qkv = x @ p["wqkv"]
        if cfg.qkv_bias:
            qkv = qkv + p["bqkv"]
        q = qkv[..., : nq * hd]
        k = qkv[..., nq * hd: (nq + nkv) * hd]
        v = qkv[..., (nq + nkv) * hd:]
    else:
        kv_src = x if kv_src is None else kv_src
        q = x @ p["wq" + sfx]
        k = kv_src @ p["wk" + sfx]
        v = kv_src @ p["wv" + sfx]
        if cfg.qkv_bias:
            q = q + p["bq" + sfx]
            k = k + p["bk" + sfx]
            v = v + p["bv" + sfx]
    return _split_heads(q, nq), _split_heads(k, nkv), _split_heads(v, nkv)


def _rope(cfg: ModelConfig, x: Tensor, positions: Tensor) -> Tensor:
    """RoPE at positions (B, S); M-RoPE for the VLM, whose three position
    streams coincide in the text-only backbone (JAX `model.py:97-101`)."""
    if cfg.mrope_sections:
        b, s = positions.shape
        return nn.apply_mrope(x, positions[:, None, :].expand(b, 3, s),
                              cfg.mrope_sections, cfg.rope_theta)
    return nn.apply_rope(x, positions, cfg.rope_theta)


def attn_branch(cfg: ModelConfig, x: Tensor, p: Dict, run: RunConfig,
                positions: Tensor, *, causal: bool = True,
                use_rope: bool = True, window: int = 0,
                kv_src: Optional[Tensor] = None, sfx: str = "",
                rules: ShardingRules = NULL_RULES) -> Tensor:
    q, k, v = _qkv(cfg, x, p, kv_src, sfx)
    if use_rope:
        q, k = _rope(cfg, q, positions), _rope(cfg, k, positions)
    if run.qkv_constraints:
        q = rules.constrain(q, "batch", "heads", "seq", "head_dim")
        k = rules.constrain(k, "batch", "kv_heads", None, "head_dim")
        v = rules.constrain(v, "batch", "kv_heads", None, "head_dim")
    out = _attend(run, q, k, v, causal=causal, window=window)
    return _merge_heads(out) @ p["wo" + sfx]


def mla_branch(cfg: ModelConfig, x: Tensor, p: Dict, run: RunConfig,
               positions: Tensor, rules: ShardingRules = NULL_RULES
               ) -> Tensor:
    """Multi-head latent attention (DeepSeek-V2): q and the shared KV
    latent through low-rank projections, a decoupled RoPE part of
    `rope_head_dim` per head (one key head shared by all), scale
    1 / sqrt(hd + rd)."""
    b, s, _ = x.shape
    hq, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_head_dim
    cq = nn.rms_norm(x @ p["wdq"], p["q_norm"])
    q_nope = _split_heads(cq @ p["wuq"], hq)                    # (B,H,S,hd)
    q_rope = nn.apply_rope(_split_heads(cq @ p["wq_rope"], hq), positions,
                           cfg.rope_theta)
    ckv = nn.rms_norm(x @ p["wdkv"], p["kv_norm"])              # (B,S,r_kv)
    k_rope = nn.apply_rope(_split_heads(x @ p["wk_rope"], 1), positions,
                           cfg.rope_theta)                      # (B,1,S,rd)
    k_nope = _split_heads(ckv @ p["wuk"], hq)
    v = _split_heads(ckv @ p["wuv"], hq)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, hq, s, rd)], dim=-1)
    if run.qkv_constraints:
        q = rules.constrain(q, "batch", "heads", "seq", None)
        k = rules.constrain(k, "batch", "heads", None, None)
        v = rules.constrain(v, "batch", "heads", None, None)
    out = _attend(run, q, k, v, causal=True, scale=1.0 / math.sqrt(hd + rd))
    return _merge_heads(out) @ p["wo"]


def ffn_branch(cfg: ModelConfig, x: Tensor, p: Dict,
               run: RunConfig = RunConfig(),
               rules: ShardingRules = NULL_RULES) -> Tensor:
    b, s, d = x.shape
    if cfg.n_experts > 0:
        cf = run.moe_capacity_factor or cfg.capacity_factor
        experts = (x.reshape(b * s, d), p["router"], p["we_gate"],
                   p["we_up"], p["we_down"])
        if run.moe_dispatch == "grouped":
            y = moe.moe_ffn_grouped(*experts, top_k=cfg.top_k,
                                    capacity_factor=cf,
                                    n_groups=run.moe_groups, rules=rules)
        else:
            y = moe.moe_ffn(*experts, top_k=cfg.top_k, capacity_factor=cf,
                            rules=rules)
        y = y.reshape(b, s, d)
        if cfg.n_shared_experts > 0:
            y = y + moe.shared_expert_ffn(x, p)
        return y
    if cfg.act == "swiglu":
        gate, up = (x @ p["w_gu"]).chunk(2, dim=-1)   # fused gate + up
        h = rules.constrain(torch.nn.functional.silu(gate) * up,
                            "batch", "seq", "ffn")
        return h @ p["w_down"]
    return nn.ffn_gelu(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _zeros(x: Tensor, *shape, dtype: torch.dtype) -> Tensor:
    """A zero state of `shape` on x's device (replicated on x's mesh)."""
    return lift(torch.zeros(shape, dtype=dtype, device=x.device), x)


def block(cfg: ModelConfig, x: Tensor, lp: Dict, run: RunConfig,
          positions: Tensor, enc_out: Optional[Tensor] = None,
          rules: ShardingRules = NULL_RULES) -> Tensor:
    """One pre-norm decoder block of `cfg`'s family (JAX `_make_block`)."""
    B = x.shape[0]
    if cfg.mixer == "rwkv6":
        wkv0 = _zeros(x, B, cfg.n_heads, cfg.hd, cfg.hd, dtype=torch.float32)
        shift0 = _zeros(x, B, cfg.d_model, dtype=x.dtype)
        y, _ = rwkv6.time_mix(_norm(cfg, x, lp, "norm1"), lp, (wkv0, shift0),
                              cfg.n_heads)
        x = x + y
        y, _ = rwkv6.channel_mix(_norm(cfg, x, lp, "norm2"), lp, shift0)
        return x + y

    h = _norm(cfg, x, lp, "norm1")
    if cfg.mixer == "mla":
        y = mla_branch(cfg, h, lp, run, positions, rules)
    elif cfg.mixer == "hymba":
        y_attn = attn_branch(cfg, h, lp, run, positions,
                             window=cfg.sliding_window, rules=rules)
        d_in = cfg.ssm_expand * cfg.d_model
        st = (_zeros(x, B, d_in, cfg.ssm_state, dtype=torch.float32),
              _zeros(x, B, cfg.conv_width - 1, d_in, dtype=x.dtype))
        y_ssm, _ = mamba.ssm_branch(h, lp, st, cfg.ssm_state)
        y = 0.5 * (y_attn + y_ssm)
    else:
        y = attn_branch(cfg, h, lp, run, positions, causal=True,
                        use_rope=not cfg.is_encoder_decoder,
                        window=cfg.sliding_window, rules=rules)
    x = x + _tag(y, "mix_out", run)
    if cfg.is_encoder_decoder:
        h = _norm(cfg, x, lp, "norm3")
        x = x + attn_branch(cfg, h, lp, run, positions, causal=False,
                            use_rope=False, kv_src=enc_out, sfx="_x",
                            rules=rules)
    h = _norm(cfg, x, lp, "norm2")
    x = x + _tag(ffn_branch(cfg, h, lp, run, rules), "ffn_out", run)
    return rules.constrain(x, "batch", "seq", "embed")


def _layers(tree: Dict, n_layers: int):
    """The per-layer parameter dicts of a stacked ``(L, ...)`` tree.  One
    unbind per stacked leaf: its backward stacks the layers' gradients
    once, where a view per layer would add a full-size zero-padded
    gradient per layer."""
    split = {name: t.unbind(0) for name, t in tree.items()}
    return [{name: ts[i] for name, ts in split.items()}
            for i in range(n_layers)]


def _final_norm(cfg: ModelConfig, x: Tensor, p: Dict) -> Tensor:
    if cfg.norm == "ln":
        return nn.layer_norm(x, p["final_norm"], p["final_norm_bias"])
    return nn.rms_norm(x, p["final_norm"])


def encode(cfg: ModelConfig, params: Dict, frames: Tensor,
           run: RunConfig = RunConfig(),
           rules: ShardingRules = NULL_RULES) -> Tensor:
    """Whisper's encoder: frames (B, enc_seq, D), the precomputed frame
    embeddings (the conv frontend is a stub, as in the JAX package), plus
    sinusoidal positions, through non-causal pre-norm blocks and the
    encoder's final norm.  The frames are cast to the model dtype (the
    JAX stack promotes f32 frames against bf16 weights to f32; in an f32
    model the two agree)."""
    x = frames.to(cfg.torch_dtype)
    x = x + lift(nn.sinusoidal_positions(x.shape[1], cfg.d_model,
                                         device=x.device).to(x.dtype), x)
    positions = lift(torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2]), x)
    enc = params["encoder"]

    def enc_block(x: Tensor, lp: Dict) -> Tensor:
        h = _norm(cfg, x, lp, "norm1")
        x = x + attn_branch(cfg, h, lp, run, positions, causal=False,
                            use_rope=False, rules=rules)
        h = _norm(cfg, x, lp, "norm2")
        x = x + ffn_branch(cfg, h, lp, run, rules)
        return rules.constrain(x, "batch", "frames", "embed")

    enc_block = _maybe_remat(enc_block, run)
    for lp in _layers(enc["layers"], cfg.n_encoder_layers):
        x = enc_block(x, lp)
    return _final_norm(cfg, x, enc)


def embed(params: Dict, tokens: Tensor) -> Tensor:
    """The embedding rows of `tokens`.  Under a mesh (DTensor table and
    tokens) each rank looks its tokens up in its own rows of the table
    (zero for a token outside them), the table gathered over the mesh
    dims that shard the tokens or the table's embed dim; the rows are a
    pending sum over the vocab's mesh dims."""
    w = params["embed"]
    if not is_dtensor(w):
        return w[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    tok = tuple(tokens.placements)
    on_vocab = [p.is_shard(0) and not t.is_shard()
                for p, t in zip(w.placements, tok)]
    lay = tuple(Shard(0) if v else Replicate() for v in on_vocab)
    v_lo, v_n = shard_range(w.shape[0], lay, mesh, 0)
    grad_w = tuple(Shard(0) if v else Partial() if t.is_shard() else
                   Replicate() for v, t in zip(on_vocab, tok))
    out = tuple(Partial() if v else t for v, t in zip(on_vocab, tok))

    def local(wl, tl):
        idx = tl.long() - v_lo
        ok = (idx >= 0) & (idx < v_n)
        rows = wl[idx.clamp(0, max(v_n - 1, 0))]
        return torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=rows.dtype))

    return local_map(local, out_placements=list(out),
                     in_placements=(lay, tok),
                     in_grad_placements=(grad_w, tok),
                     device_mesh=mesh, redistribute_inputs=True)(w, tokens)


def forward(cfg: ModelConfig, params: Dict, tokens: Tensor,
            run: RunConfig = RunConfig(), *,
            vision_embeds: Optional[Tensor] = None,
            encoder_frames: Optional[Tensor] = None,
            rules: ShardingRules = NULL_RULES) -> Tensor:
    """tokens (B, S) -> logits (B, S, V), on the device of the params.

    vision_embeds: optional (B, nv, D) for the VLM; they replace the
    first nv token embeddings (the vision frontend is a stub, as in the
    JAX package).  encoder_frames: (B, enc_seq, D), required by the
    encoder-decoder (whisper)."""
    B, S = tokens.shape
    x = embed(params, tokens).to(cfg.torch_dtype)
    if cfg.family == "vlm" and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    enc_out = None
    if cfg.is_encoder_decoder:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name} needs encoder frames")
        x = x + lift(nn.sinusoidal_positions(S, cfg.d_model,
                                             device=x.device).to(x.dtype), x)
        enc_out = encode(cfg, params, encoder_frames, run, rules)
    x = rules.constrain(x, "batch", "seq", "embed")
    positions = lift(torch.arange(S, device=x.device).expand(B, S), x)
    blk = _maybe_remat(
        lambda x, lp: block(cfg, x, lp, run, positions, enc_out, rules), run)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = blk(x, lp)
    x = _final_norm(cfg, x, params)
    logits = x @ params["lm_head"].T.to(x.dtype)
    return rules.constrain(logits, "batch", "seq", "vocab")


def _picked(lg: Tensor, tg: Tensor) -> Tensor:
    """lg[..., tg]: the logit of each target.  Under a mesh whose ranks
    hold shards of the vocab, each picks from its own shard (zero for a
    target outside it) and the picks are a pending sum over the vocab's
    mesh dims: no rank gathers the logits."""
    if not is_dtensor(lg):
        return torch.gather(lg, -1, tg[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, lay, vd = lg.device_mesh, tuple(lg.placements), lg.ndim - 1
    v_lo, v_n = shard_range(lg.shape[-1], lay, mesh, vd)
    on_vocab = [p.is_shard(vd) for p in lay]
    tok = tuple(Replicate() if v else p for v, p in zip(on_vocab, lay))
    out = tuple(Partial() if v else p for v, p in zip(on_vocab, lay))

    def local(lgl, tgl):
        idx = tgl.long() - v_lo
        ok = (idx >= 0) & (idx < v_n)
        got = torch.gather(lgl, -1, idx.clamp(0, max(v_n - 1, 0))[..., None])
        return torch.where(ok, got[..., 0], torch.zeros((), dtype=got.dtype))

    return local_map(local, out_placements=list(out),
                     in_placements=(lay, tok),
                     device_mesh=mesh, redistribute_inputs=True)(lg, tg)


def lm_loss(logits: Tensor, tokens: Tensor) -> Tensor:
    """Next-token cross entropy (f32 logsumexp), mean over tokens."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    return (lse - _picked(lg, tg)).mean()
