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
a sharded batch).

Under rules bound to a DeviceMesh (DTensor operands) the dispatch runs on
local shards (`local_map`: sort, scatter_add_ and index_copy have no
DTensor rule): each rank routes its tokens — its groups over the
``moe_group`` axis (data) for `moe_ffn_grouped`, all tokens for
`moe_ffn` — to every expert, but fills the buffer rows of its own
experts only (the ``expert`` axis, model) and runs their FFNs; the
combine is then a sum over the expert ranks (a pending sum, reduced at
the next constraint).  That is the layout the JAX package's constraints
name: the (G, E, C, d) buffer over (moe_group, expert).  The router and
the expert weights are gathered over the axes that do not shard experts
(under fsdp: their embed dim), and their gradients come back as sums.

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

import math
from typing import Dict, Tuple

import torch

from ..dist.sharding import shard_range

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
                  C: int, n_experts: int = 0, e_lo: int = 0) -> Tensor:
    """The capacity-bounded dispatch, expert FFN and combine of G groups
    of Tg tokens; xg (G, Tg, d), gate_w / gate_idx (G, Tg, k).  Returns
    (G, Tg, d).  With `n_experts` > the weights' E_loc, the weights are
    experts e_lo .. e_lo + E_loc - 1 of n_experts: only their assignments
    are computed (the others add zero)."""
    G, Tg, d = xg.shape
    k = gate_idx.shape[-1]
    E_loc = we_gate.shape[0]
    E = n_experts or E_loc
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
    if E_loc < E:                                # another rank's experts
        keep = keep & (e_sorted >= e_lo) & (e_sorted < e_lo + E_loc)
    # each kept assignment's row of the (G, E_loc, C) buffer; a dropped
    # one's is the spare row G * E_loc * C, cut off below
    n_rows = G * E_loc * C
    rows = torch.where(
        keep,
        (torch.arange(G, device=dev)[:, None] * E_loc + e_sorted - e_lo) * C
        + slot,
        n_rows)
    t_sorted = order // k                        # token of each assignment
    tokens = torch.gather(xg, 1, t_sorted[..., None].expand(G, Tg * k, d))
    buf = xg.new_zeros(n_rows + 1, d).index_copy(
        0, rows.reshape(-1), tokens.reshape(-1, d))
    buf = buf[:-1].reshape(G, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, G * C, d)

    h = torch.nn.functional.silu(torch.bmm(buf, we_gate))
    h = h * torch.bmm(buf, we_up)
    y = torch.bmm(h, we_down)                                # (E_loc,G*C,d)
    y = y.reshape(E_loc, G, C, d).transpose(0, 1).reshape(n_rows, d)

    # combine: assignment j of token t is the sorted entry inv[t * k + j]
    y_assign = torch.where(keep[..., None],
                           y[rows.clamp(max=n_rows - 1)].reshape(
                               G, Tg * k, d),
                           torch.zeros((), dtype=y.dtype, device=dev))
    inv = torch.argsort(order, dim=1)
    y_tok = torch.gather(y_assign, 1, inv[..., None].expand(G, Tg * k, d))
    w = gate_w.reshape(G, Tg * k, 1).to(xg.dtype)
    return (y_tok * w).reshape(G, Tg, k, d).sum(dim=2)


def _sharded(x: Tensor, router: Tensor, we_gate: Tensor, we_up: Tensor,
             we_down: Tensor, *, top_k: int, C: int, n_groups: int,
             rules, router_dtype: torch.dtype, tok: Tuple) -> Tensor:
    """The dispatch of DTensor operands on local shards (module doc):
    x (T, d) laid out by the token placements `tok` (whole groups per
    rank), experts by ``rules.spec("expert", ...)``.  Returns (T, d) in
    `tok`, a pending sum over the mesh dims that shard the experts."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = rules.mesh
    T, d = x.shape
    E = router.shape[1]
    exp = rules.placements("expert", None, None)
    tok_dims = {i for i, p in enumerate(tok) if p.is_shard()}
    exp_dims = [i for i, p in enumerate(exp) if p.is_shard()]
    if tok_dims & set(exp_dims) or len(exp_dims) > 1:
        raise ValueError(f"MoE: tokens over mesh dims {sorted(tok_dims)} "
                         f"and experts over {exp_dims} must be disjoint, "
                         "the experts over one dim at most")
    n_tok = math.prod(mesh.size(i) for i in tok_dims)
    if n_groups % n_tok:
        raise ValueError(f"{n_groups} token groups do not split over the "
                         f"{n_tok} ranks of the moe_group axis")
    e_lo = shard_range(E, exp, mesh, 0)[0]
    split = tok_dims | set(exp_dims)
    rep = (Replicate(),) * mesh.ndim

    def grad(pl):
        # a replicated operand's gradient from this rank's tokens and
        # experts is a part of a sum over the dims that split them
        return tuple(p if p.is_shard() else
                     Partial() if i in split else Replicate()
                     for i, p in enumerate(pl))

    out = tuple(Partial() if i in exp_dims else p for i, p in enumerate(tok))

    def local(xl, rl, wg, wu, wd):
        g = n_groups * xl.shape[0] // T
        xg = xl.reshape(g, -1, d)
        gate_w, gate_idx = route(xg, rl, top_k, router_dtype)
        return _dispatch_ffn(xg, gate_w, gate_idx, wg, wu, wd, C,
                             n_experts=E, e_lo=e_lo).reshape(-1, d)

    fn = local_map(local, out_placements=list(out),
                   in_placements=(tok, rep, exp, exp, exp),
                   in_grad_placements=(grad(tok), grad(rep), grad(exp),
                                       grad(exp), grad(exp)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, router, we_gate, we_up, we_down)


def moe_ffn(x: Tensor, router: Tensor, we_gate: Tensor, we_up: Tensor,
            we_down: Tensor, *, top_k: int, capacity_factor: float = 1.25,
            router_dtype: torch.dtype = torch.float32,
            rules=None) -> Tensor:
    """x: (T, d); router: (d, E); we_*: (E, d, F) / (E, F, d).  Returns
    (T, d).  Under `rules` with a mesh every rank sorts all T tokens (the
    global sort) for its own experts; the output is laid out over
    ``batch``."""
    T, d = x.shape
    C = capacity(T, router.shape[1], top_k, capacity_factor)
    if rules is not None and rules.mesh is not None:
        from torch.distributed.tensor import Replicate

        tok = (Replicate(),) * rules.mesh.ndim
        y = _sharded(x, router, we_gate, we_up, we_down, top_k=top_k, C=C,
                     n_groups=1, rules=rules, router_dtype=router_dtype,
                     tok=tok)
        return rules.constrain(y, "batch", None)
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
    tokens.  Under `rules` with a mesh the groups are laid out over
    ``moe_group`` and the experts over ``expert`` (module doc)."""
    T, d = x.shape
    G = n_groups
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    C = capacity(Tg, router.shape[1], top_k, capacity_factor)
    if rules is not None and rules.mesh is not None:
        # groups are contiguous runs of tokens: the (T, d) layout over
        # moe_group is the (G, Tg, d) one of the JAX constraint
        tok = rules.placements("moe_group", None)
        y = _sharded(x, router, we_gate, we_up, we_down, top_k=top_k, C=C,
                     n_groups=G, rules=rules, router_dtype=router_dtype,
                     tok=tok)
        return rules.constrain(y, "moe_group", None)
    xg = x.reshape(G, Tg, d)
    gate_w, gate_idx = route(xg, router, top_k, router_dtype)
    return _dispatch_ffn(xg, gate_w, gate_idx, we_gate, we_up, we_down,
                         C).reshape(T, d)
