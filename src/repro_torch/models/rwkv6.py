"""RWKV6 (Finch) token and channel mixing — attention-free, with a
data-dependent decay (the JAX package's `models/rwkv6.py`):

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(base + lora(x_t)))

with a per-(head, channel) decay w_t.  Static token-shift mix coefficients
stand in for RWKV6's LoRA token shift, as in the JAX package.  The state
carried per layer:

    wkv      (B, H, hd, hd)   the matrix-valued wkv state, f32
    shift    (B, D)           the last normed input of the time mix
    cm_shift (B, D)           the last normed input of the channel mix

Roundings follow the JAX package: r, k, v and g are projected in the
model dtype and widened to f32; the decay adds its base and LoRA in the
model dtype and takes exp(-exp(.)) in f32; the recurrence runs in f32
and the state is cast back to its own dtype.  The recurrence is a Python
loop over the sequence (the JAX package scans it): one step of a few
small products per token.  Under a mesh (DTensor operands) it runs on
each rank's shards of the batch and the heads (`local_map`: its einsum
flattens the sharded heads, which DTensor refuses in some torches).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..dist.sharding import is_dtensor, lift, reshape
from . import layers as nn

Tensor = torch.Tensor


def _project(x, xprev, mu, w):
    return (x + mu * (xprev - x)) @ w


def _decay(x, xprev, p):
    xw = x + p["mu_w"] * (xprev - x)
    lora = torch.tanh(xw @ p["w_dd1"]) @ p["w_dd2"]
    return torch.exp(-torch.exp((p["decay_base"] + lora).float()))


def time_mix(x: Tensor, p: Dict, state: Tuple[Tensor, Tensor],
             n_heads: int) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """x: (B, S, D) normed input; state (wkv (B, H, hd, hd), shift (B, D)).
    Returns (y (B, S, D), (wkv, shift)), the state new tensors."""
    B, S, D = x.shape
    H = n_heads
    hd = D // H
    wkv0, shift0 = state
    xprev = nn.token_shift(x, shift0)

    heads = (B, S, H, hd)
    r = reshape(_project(x, xprev, p["mu_r"], p["w_r"]), heads).float()
    k = reshape(_project(x, xprev, p["mu_k"], p["w_k"]), heads).float()
    v = reshape(_project(x, xprev, p["mu_v"], p["w_v"]), heads).float()
    g = torch.nn.functional.silu(_project(x, xprev, p["mu_g"], p["w_g"]))
    w = reshape(_decay(x, xprev, p), heads)
    u = p["bonus"].float()[None, :, :, None]                    # (1,H,hd,1)

    scan = _local_wkv if is_dtensor(r) else _wkv
    y, s = scan(r, k, v, w, u, wkv0.float())                    # (B,S,H,hd)
    y = nn.group_norm_heads(y, p["ln_x"]).to(x.dtype)
    y = (reshape(y, (B, S, D)) * g) @ p["w_o"]
    return y, (s.to(wkv0.dtype), x[:, -1, :])


def _wkv(r, k, v, w, u, s):
    """The wkv recurrence over the sequence: r, k, v, w (B, S, H, hd), u
    (1, H, hd, 1), s (B, H, hd, hd), f32.  Returns (y (B, S, H, hd), the
    last state)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _local_wkv(r, k, v, w, u, s):
    """`_wkv` of DTensor operands on each rank's shards: batch and heads
    laid out as r's (the state and the bonus cut alike); a mesh dim that
    shards anything else, or the heads unevenly, is gathered first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = r.device_mesh
    H = r.shape[2]
    heads = [i for i, p in enumerate(r.placements) if p.is_shard(2)]
    even = H % math.prod(mesh.size(i) for i in heads) == 0
    seq = tuple(p if p.is_shard(0) or (p.is_shard(2) and even)
                else Replicate() for p in r.placements)
    # the same cut on the state (B, H, ...) and the bonus (1, H, ...);
    # the bonus's gradient from this rank's batch is a part of a sum
    state = tuple(Shard(1) if p.is_shard(2) else p for p in seq)
    bonus = tuple(Shard(1) if p.is_shard(2) else Replicate() for p in seq)
    bonus_grad = tuple(Partial() if p.is_shard(0) else b
                       for p, b in zip(seq, bonus))
    return local_map(_wkv, out_placements=(list(seq), list(state)),
                     in_placements=(seq, seq, seq, seq, bonus, state),
                     in_grad_placements=(seq, seq, seq, seq, bonus_grad,
                                         state),
                     device_mesh=mesh, redistribute_inputs=True)(
        r, k, v, w, lift(u, r), lift(s, r))


def channel_mix(x: Tensor, p: Dict, shift0: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) normed input; shift0 (B, D).  Returns (out, shift)."""
    xprev = nn.token_shift(x, shift0)
    out = nn.rwkv_channel_mix(x, xprev, p["mu_ck"], p["mu_cr"], p["w_ck"],
                              p["w_cv"], p["w_cr"])
    return out, x[:, -1, :]


def init_state(cfg, batch: int, dtype: torch.dtype, device) -> Dict:
    H, hd, D, L = cfg.n_heads, cfg.hd, cfg.d_model, cfg.n_layers
    return {
        "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "shift": torch.zeros((L, batch, D), dtype=dtype, device=device),
        "cm_shift": torch.zeros((L, batch, D), dtype=dtype, device=device),
    }
