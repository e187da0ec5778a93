"""Neural primitives of the LM: norms, rotary embeddings (RoPE and
M-RoPE), sinusoidal positions, FFNs, RWKV's token shift and channel mix,
and attention (the JAX package's `models/layers.py`).

Attention has the JAX package's three implementations: 'ref'
(materialised logits), 'chunked' (a loop over query chunks) and 'flash'
(the hand-written kernel, `kernels.ops.flash_attention`), chosen by
:func:`attention` under the JAX package's exact conditions.  Tensors keep
its layouts: activations (B, S, D), heads (B, H, S, hd).  Under a mesh
(DTensor operands) the constants built here — RoPE frequencies, masks —
are lifted to replicated DTensors (`dist.sharding.lift`), and attention
runs on each rank's shards of the batch and the heads (`local_map`:
einsum's views of sharded dims have no DTensor rule in every torch).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..dist.sharding import is_dtensor, lift
from ..kernels import ops as kops

Tensor = torch.Tensor

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def group_norm_heads(x: Tensor, scale: Tensor, eps: float = 64e-5) -> Tensor:
    """Per-head LayerNorm of RWKV's wkv output; x (..., H, hd), f32
    inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (+ M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor,
               theta: float = 10_000.0) -> Tensor:
    """x: (B, H, S, hd); positions: (B, S) absolute token positions."""
    d = x.shape[-1]
    freqs = lift(rope_freqs(d, theta, device=x.device), positions)
    return _rotate(x, positions[:, None, :, None].float() * freqs)


def apply_mrope(x: Tensor, positions: Tensor, sections: Tuple[int, ...],
                theta: float = 10_000.0) -> Tensor:
    """M-RoPE (Qwen2-VL): positions (B, 3, S) = (temporal, h, w) id
    streams; `sections` splits the half-dim rotary frequency bands among
    the streams, in order.  In the text-only backbone the three streams
    coincide.  Each band is a slice of its stream, so no index tensor
    crosses from the host."""
    b, _, s = positions.shape
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"sections {tuple(sections)} must cover half the "
                         f"head dim {d}")
    freqs = lift(rope_freqs(d, theta, device=x.device), positions)
    pos = torch.cat([positions[:, i:i + 1].float().expand(b, sec, s)
                     for i, sec in enumerate(sections)], dim=1)  # (B,d/2,S)
    ang = (pos * freqs[:, None]).transpose(1, 2)[:, None]      # (B,1,S,d/2)
    return _rotate(x, ang)


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """Rotate the two halves of x's last axis by `ang` (broadcast to
    (B, 1, S, d/2)) in f32, then cast back to x's dtype."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(positions: Tensor, d_model: int) -> Tensor:
    """Whisper-style sinusoidal embeddings at the given positions (a
    tensor, read on its device); positions (..., S) -> (..., S, d_model)
    in f32, sin at the even and cos at the odd columns."""
    pos = positions.float()[..., None]
    dim = lift(torch.arange(0, d_model, 2, dtype=torch.float32,
                            device=positions.device), positions)
    ang = pos / torch.pow(10_000.0, dim / d_model)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *positions.shape, d_model)


def sinusoidal_positions(seq: int, d_model: int, device=None) -> Tensor:
    return sinusoidal_at(torch.arange(seq, device=device), d_model)


# ---------------------------------------------------------------------------
# Attention math
# ---------------------------------------------------------------------------
def _window_mask(rows: Tensor, cols: Tensor, causal: bool,
                 window: int) -> Tensor:
    ok = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                    dtype=torch.bool, device=rows.device)
    if causal:
        ok = ok & (cols <= rows)
    if window > 0:
        ok = ok & (cols > rows - window)
    return ok


_F8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _compute_dtype(x: Tensor) -> Tensor:
    """An f8 cache computes in bf16 (the JAX package's rule); every other
    dtype as it is stored."""
    return x.to(torch.bfloat16) if x.dtype in _F8 else x


def attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                  kv_valid: Optional[Tensor] = None) -> Tensor:
    """Materialised-logits attention; q (B, Hq, Sq, hd), k / v
    (B, Hkv, Sk, hd).  The causal mask is bottom-right aligned (row i of
    the queries is position Sk - Sq + i).  An f8 k / v is first widened to
    bf16.  Products then take the operands in their storage dtype with
    f32 accumulation (here: operands widened to f32, which is exact, then
    an f32 product), the probabilities are cast to v's dtype before P V,
    and the output to q's dtype.
    kv_valid: optional (B, Sk) bool mask of valid key slots."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v = _compute_dtype(k), _compute_dtype(v)
    qg = q.reshape(b, hkv, group, sq, d).to(k.dtype).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    dev = q.device
    rows = (torch.arange(sk - sq, sk, device=dev) if causal
            else torch.arange(sq, device=dev))[:, None]
    cols = torch.arange(sk, device=dev)[None, :]
    mask = lift(_window_mask(rows, cols, causal, window), s)
    if kv_valid is not None:
        mask = (mask[None] & kv_valid[:, None, :])[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=0, scale=None,
                      chunk: int = 1024) -> Tensor:
    """A loop over query chunks: working set O(chunk * Sk) instead of
    O(Sq * Sk), f32 throughout, causal mask top-left aligned per chunk
    (as the JAX package's scan).  Short or non-chunk-multiple sequences
    take :func:`attention_ref`."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if sq <= chunk or sq % chunk != 0:
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    cols = torch.arange(sk, device=q.device)[None, :]
    qg = q.reshape(b, hkv, group, sq, d)
    outs = []
    for i in range(sq // chunk):
        qi = qg[..., i * chunk:(i + 1) * chunk, :].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kf) * scale
        rows = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        mask = lift(_window_mask(rows, cols, causal, window), s)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=-2).reshape(b, hq, sq, v.shape[-1])


def attention(q, k, v, *, impl="chunked", causal=True, window=0, scale=None,
              chunk: int = 1024, kv_valid=None) -> Tensor:
    """The JAX package's dispatch rule: the flash kernel for
    ``impl="flash"`` with no window, no kv_valid mask and equal q / v head
    dims; the chunked loop for ``impl="chunked"`` without kv_valid; the
    materialised reference otherwise.  DTensor operands: the same on each
    rank's shards (`_local_attention`)."""
    if is_dtensor(q):
        return _local_attention(q, k, v, kv_valid, impl=impl, causal=causal,
                                window=window, scale=scale, chunk=chunk)
    if (impl == "flash" and window == 0 and kv_valid is None
            and q.shape[-1] == v.shape[-1]):
        return kops.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "chunked" and kv_valid is None:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 scale=scale, chunk=chunk)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         kv_valid=kv_valid)


def _local_attention(q, k, v, kv_valid, **kw) -> Tensor:
    """`attention` of DTensor operands on each rank's shards: q, k, v and
    the output laid out as q's batch and heads (k and v's heads cut like
    q's, which keeps each q head beside its kv head); a mesh dim that
    shards anything else, or the heads unevenly, is gathered first."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    heads = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                    if p.is_shard(1))
    even = q.shape[1] % heads == 0 and k.shape[1] % heads == 0
    lay = tuple(p if p.is_shard(0) or (p.is_shard(1) and even)
                else Replicate() for p in q.placements)
    mask = None
    if kv_valid is not None:
        mask = tuple(p if p.is_shard(0) else Replicate() for p in lay)
        kv_valid = lift(kv_valid, q)

    def local(ql, kl, vl, ml):
        return attention(ql, kl, vl, kv_valid=ml, **kw)

    return local_map(local, out_placements=list(lay),
                     in_placements=(lay, lay, lay, mask),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, kv_valid)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
def ffn_swiglu(x, w_gate, w_up, w_down):
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def ffn_gelu(x, w_in, b_in, w_out, b_out):
    h = torch.nn.functional.gelu(x @ w_in + b_in, approximate="tanh")
    return h @ w_out + b_out


def rwkv_channel_mix(x, x_prev, mu_k, mu_r, w_k, w_v, w_r):
    """RWKV channel mix: k = relu(xk W_k)^2, out = sigmoid(xr W_r) * (k W_v)."""
    xk = x + mu_k * (x_prev - x)
    xr = x + mu_r * (x_prev - x)
    k = torch.square(torch.relu(xk @ w_k))
    return torch.sigmoid(xr @ w_r) * (k @ w_v)


def token_shift(x: Tensor, last: Optional[Tensor] = None) -> Tensor:
    """RWKV token shift: x_{t-1} along the sequence of x (B, S, D);
    `last` (B, D) seeds position -1 (zeros without it)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)
