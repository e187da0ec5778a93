"""The dense decoder-only LM and the VLM backbone: full-sequence forward
and loss (the JAX package's `models/model.py`, dense and VLM families).

Layers run as a Python loop over the stacked ``(L, ...)`` parameters (the
JAX package scans them).  The forward is the prefill step of the JAX
package's dry run and the body of its eval loss
(`models.steps.build_loss_fn`); with ``RunConfig(attn_impl="flash")``
every layer's attention is one launch of the flash kernel.

`RunConfig` keeps the attention levers only.  The JAX package's other
levers — remat, the sharding scheme, qkv sharding constraints, the MoE
capacity and dispatch, unrolling the layer scan — steer XLA on a TPU mesh
or the MoE path, neither of which the port has, and are left out.  MLA,
MoE, RWKV, hymba and encoder-decoder configurations raise
NotImplementedError naming their ROADMAP item.  The KV-cache decode path
is `models.decode`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from . import layers as nn
from .params import check_supported

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Attention levers of the forward."""

    attn_impl: str = "chunked"      # ref | chunked | flash
    attn_chunk: int = 1024


def _norm(cfg: ModelConfig, x: Tensor, p: Dict, name: str) -> Tensor:
    if cfg.norm == "ln":
        return nn.layer_norm(x, p[name], p[name + "_bias"])
    return nn.rms_norm(x, p[name])


def _split_heads(x: Tensor, n_heads: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)


def _merge_heads(x: Tensor) -> Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _qkv(cfg: ModelConfig, x: Tensor, p: Dict):
    """The fused QKV projection, split into (B, H, S, hd) head views."""
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = x @ p["wqkv"]
    if cfg.qkv_bias:
        qkv = qkv + p["bqkv"]
    q = qkv[..., : nq * hd]
    k = qkv[..., nq * hd: (nq + nkv) * hd]
    v = qkv[..., (nq + nkv) * hd:]
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
                window: int = 0) -> Tensor:
    q, k, v = _qkv(cfg, x, p)
    q, k = _rope(cfg, q, positions), _rope(cfg, k, positions)
    out = nn.attention(q, k, v, impl=run.attn_impl, causal=causal,
                       window=window, chunk=run.attn_chunk)
    return _merge_heads(out) @ p["wo"]


def ffn_branch(cfg: ModelConfig, x: Tensor, p: Dict) -> Tensor:
    if cfg.act == "swiglu":
        gate, up = (x @ p["w_gu"]).chunk(2, dim=-1)   # fused gate + up
        return (torch.nn.functional.silu(gate) * up) @ p["w_down"]
    return nn.ffn_gelu(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def block(cfg: ModelConfig, x: Tensor, lp: Dict, run: RunConfig,
          positions: Tensor) -> Tensor:
    """One pre-norm decoder block: x + attn(norm1 x), then + ffn(norm2 x)."""
    h = _norm(cfg, x, lp, "norm1")
    x = x + attn_branch(cfg, h, lp, run, positions, causal=True,
                        window=cfg.sliding_window)
    h = _norm(cfg, x, lp, "norm2")
    return x + ffn_branch(cfg, h, lp)


def forward(cfg: ModelConfig, params: Dict, tokens: Tensor,
            run: RunConfig = RunConfig(), *,
            vision_embeds: Optional[Tensor] = None) -> Tensor:
    """tokens (B, S) -> logits (B, S, V), on the device of the params.

    vision_embeds: optional (B, nv, D) for the VLM; they replace the
    first nv token embeddings (the vision frontend is a stub, as in the
    JAX package)."""
    check_supported(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if cfg.family == "vlm" and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where a view per layer would add a full-size
    # zero-padded gradient per layer
    layer_params = {name: t.unbind(0)
                    for name, t in params["layers"].items()}
    for i in range(cfg.n_layers):
        lp = {name: ts[i] for name, ts in layer_params.items()}
        x = block(cfg, x, lp, run, positions)
    if cfg.norm == "ln":
        x = nn.layer_norm(x, params["final_norm"], params["final_norm_bias"])
    else:
        x = nn.rms_norm(x, params["final_norm"])
    return x @ params["lm_head"].T.to(x.dtype)


def lm_loss(logits: Tensor, tokens: Tensor) -> Tensor:
    """Next-token cross entropy (f32 logsumexp), mean over tokens."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:]
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tg[..., None].long())[..., 0]
    return (lse - picked).mean()
