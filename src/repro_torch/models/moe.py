"""Mixture-of-experts FFN with capacity-bounded dispatch (the JAX package's
`models/moe.py`).

1. route: the top-k experts of each token (a softmax over the selected
   router logits, f32);
2. sort the (token, expert) assignments by expert (stable) and give each
   its slot within its expert's capacity C; assignments past C drop;
3. copy the tokens into an (E, C, d) buffer, run the expert FFNs as
   batched products over the expert axis, gather each assignment's
   output back and sum a token's top-k outputs, weighted.

`moe_ffn` sorts all T*k assignments at once; `moe_ffn_grouped` splits the
tokens into groups and sorts within each (the JAX package's dispatch for
a sharded batch; the port runs it on one device and takes no sharding
rules).

Three rules keep a step free of host reads and of run-to-run noise on
the card: the counts per expert are a `scatter_add_` into E zeros (no
`bincount`, which sizes its output on the host), dropped assignments are
sent to a spare row of the buffer (no boolean index), and the combine
gathers each token's k outputs back into (T, k, d) and sums over k (no
atomic scatter-add, whose order varies).  The JAX package adds them into
(T, d) one assignment after another in expert order: in f32 the two
agree to rounding, in bf16 to a bf16 ulp of the output.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float, multiple: int = 8) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    c = max(multiple, -(-c // multiple) * multiple)
    return min(c, n_tokens)


def route(x: Tensor, router: Tensor, top_k: int,
          router_dtype: torch.dtype = torch.float32
          ) -> Tuple[Tensor, Tensor]:
    """(gate weights, expert ids), each (..., k): the k largest router
    logits of each token, largest first, ties to the lower expert id (as
    `jax.lax.top_k`), and the softmax over them."""
    logits = x.to(router_dtype) @ router.to(router_dtype)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :top_k], dim=-1), idx[..., :top_k]


def _dispatch_ffn(xg: Tensor, gate_w: Tensor, gate_idx: Tensor,
                  we_gate: Tensor, we_up: Tensor, we_down: Tensor,
                  C: int) -> Tensor:
    """The capacity-bounded dispatch, expert FFN and combine of G groups
    of Tg tokens; xg (G, Tg, d), gate_w / gate_idx (G, Tg, k).  Returns
    (G, Tg, d)."""
    G, Tg, d = xg.shape
    k = gate_idx.shape[-1]
    E = we_gate.shape[0]
    dev = xg.device
    e_flat = gate_idx.reshape(G, Tg * k)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=dev).scatter_add_(
        1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=1) - counts                # exclusive
    slot = (torch.arange(Tg * k, device=dev)[None, :]
            - torch.gather(starts, 1, e_sorted))
    keep = slot < C
    # each kept assignment's row of the (G, E, C) buffer; a dropped one's
    # is the spare row G * E * C, cut off below
    rows = torch.where(
        keep,
        (torch.arange(G, device=dev)[:, None] * E + e_sorted) * C + slot,
        G * E * C)
    t_sorted = order // k                        # token of each assignment
    tokens = torch.gather(xg, 1, t_sorted[..., None].expand(G, Tg * k, d))
    buf = xg.new_zeros(G * E * C + 1, d).index_copy(
        0, rows.reshape(-1), tokens.reshape(-1, d))
    buf = buf[:-1].reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)

    h = torch.nn.functional.silu(torch.bmm(buf, we_gate))
    h = h * torch.bmm(buf, we_up)
    y = torch.bmm(h, we_down)                                    # (E, G*C, d)
    y = y.reshape(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

    # combine: assignment j of token t is the sorted entry inv[t * k + j]
    y_assign = torch.where(keep[..., None],
                           y[rows.clamp(max=G * E * C - 1)].reshape(
                               G, Tg * k, d),
                           torch.zeros((), dtype=y.dtype, device=dev))
    inv = torch.argsort(order, dim=1)
    y_tok = torch.gather(y_assign, 1, inv[..., None].expand(G, Tg * k, d))
    w = gate_w.reshape(G, Tg * k, 1).to(xg.dtype)
    return (y_tok * w).reshape(G, Tg, k, d).sum(dim=2)


def moe_ffn(x: Tensor, router: Tensor, we_gate: Tensor, we_up: Tensor,
            we_down: Tensor, *, top_k: int, capacity_factor: float = 1.25,
            router_dtype: torch.dtype = torch.float32) -> Tensor:
    """x: (T, d); router: (d, E); we_*: (E, d, F) / (E, F, d).  Returns
    (T, d)."""
    T, d = x.shape
    C = capacity(T, router.shape[1], top_k, capacity_factor)
    gate_w, gate_idx = route(x, router, top_k, router_dtype)
    return _dispatch_ffn(x[None], gate_w[None], gate_idx[None], we_gate,
                         we_up, we_down, C)[0]


def shared_expert_ffn(x: Tensor, p: Dict) -> Tensor:
    h = torch.nn.functional.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
    return h @ p["ws_down"]


def moe_ffn_grouped(x: Tensor, router: Tensor, we_gate: Tensor,
                    we_up: Tensor, we_down: Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, n_groups: int = 1,
                    rules=None,
                    router_dtype: torch.dtype = torch.float32) -> Tensor:
    """Group-local dispatch: the T tokens split into `n_groups` groups of
    T / G, each sorted and slotted on its own, with the capacity of T / G
    tokens.  `rules` (the JAX package's sharding constraints) must be
    None: the port does not shard the model."""
    if rules is not None:
        raise NotImplementedError("moe_ffn_grouped: sharding rules are not "
                                  "ported (the port runs on one device)")
    T, d = x.shape
    G = n_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity(Tg, router.shape[1], top_k, capacity_factor)
    xg = x.reshape(G, Tg, d)
    gate_w, gate_idx = route(xg, router, top_k, router_dtype)
    return _dispatch_ffn(xg, gate_w, gate_idx, we_gate, we_up, we_down,
                         C).reshape(T, d)
