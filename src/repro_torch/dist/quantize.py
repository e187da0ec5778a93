"""The wire codec of the sharded exchange: what a boundary tile looks like
on the wire, in three widths (the JAX package's `repro.dist.quantize`).

``"f32"``
    Identity: the (..., h) tile crosses the wire untouched (4h bytes per
    boundary row).
``"bf16"``
    ``.to(torch.bfloat16)``, round to nearest even as the reference's
    ``astype`` (2h bytes per row); decode widens it back.
``"int8"``
    Per-row symmetric quantization: each row is scaled by its max-abs,
    rounded to 127 levels and shipped as int8.  The f32 scale rides in the
    same tensor, its four bytes viewed as int8 lanes after the payload, so
    the message is one (..., h + 4) int8 tensor (h + 4 bytes per row) and
    one send per offset still carries payload and scale: the counted
    rounds stay the paper's 2K|E|.  On a little-endian host
    ``scale.view(torch.int8)`` is the reference's
    ``bitcast_convert_type``, so the wires are equal byte for byte.

Error feedback (:func:`ef_init` / :func:`ef_encode`) carries the residual
``t - decode(encode(t))`` of one round into the tile of the next, so int8's
rounding accumulates like a random walk instead of a bias.  The exchange
matvec threads the residuals across the K orders through the
stateful-matvec protocol (`core.chebyshev._stateful_matvec`).

These are plain PyTorch ops on whatever device the tile lives on; the JAX
package computes them with `jnp` outside any kernel too.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

#: The wire dtypes of the exchange, in decreasing width.
EXCHANGE_DTYPES = ("f32", "bf16", "int8")

#: Symmetric int8 quantization levels (sign bit + 7 magnitude bits).
_INT8_LEVELS = 127.0

#: Bytes of the f32 scale appended to each int8 row.
_SCALE_TAIL = 4


def validate_exchange_dtype(dtype: str) -> str:
    """Return `dtype` if it is a wire dtype, else raise ValueError."""
    if dtype not in EXCHANGE_DTYPES:
        raise ValueError(
            f"exchange_dtype must be one of {EXCHANGE_DTYPES}, "
            f"got {dtype!r}")
    return dtype


def tile_wire_bytes(h: int, dtype: str) -> int:
    """Wire bytes of one encoded boundary row of width `h`: f32 4h, bf16
    2h, int8 h + 4 (payload and scale).  The byte models of the plans
    (`halo_bytes_per_apply`, `general_bytes_per_apply`) are built on it."""
    validate_exchange_dtype(dtype)
    if dtype == "f32":
        return 4 * h
    if dtype == "bf16":
        return 2 * h
    return h + _SCALE_TAIL


def encode(x: Tensor, dtype: str) -> Tensor:
    """Encode a (..., h) boundary tile for the wire: f32 is `x` itself,
    bf16 a (..., h) bfloat16 tensor, int8 the (..., h + 4) payload with
    its packed scale."""
    validate_exchange_dtype(dtype)
    if dtype == "f32":
        return x
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    # the reference's order: divide, scale to the levels, round half to
    # even, clip, cast
    q = torch.clamp(torch.round(xf / scale * _INT8_LEVELS),
                    -_INT8_LEVELS, _INT8_LEVELS).to(torch.int8)
    packed = scale.contiguous().view(torch.int8)           # (..., 4)
    return torch.cat([q, packed], dim=-1)


def decode(wire: Tensor, dtype: str,
           out_dtype: torch.dtype = torch.float32) -> Tensor:
    """Invert :func:`encode`: the (..., h) tile in `out_dtype`."""
    validate_exchange_dtype(dtype)
    if dtype in ("f32", "bf16"):
        return wire.to(out_dtype)
    q = wire[..., :-_SCALE_TAIL].to(torch.float32)
    # a copy of the scale lanes, so the f32 view starts aligned
    scale = wire[..., -_SCALE_TAIL:].clone(
        memory_format=torch.contiguous_format).view(torch.float32)
    # divide by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, which rounds differently from the reference
    step = scale / torch.full_like(scale, _INT8_LEVELS)
    return (q * step).to(out_dtype)


def ef_init(x: Tensor) -> Tensor:
    """Zero error-feedback residual of one boundary tile `x` (f32)."""
    return torch.zeros_like(x, dtype=torch.float32)


def ef_encode(x: Tensor, residual: Tensor,
              dtype: str) -> Tuple[Tensor, Tensor]:
    """Error-feedback encode: ``(wire, new_residual)``.  Encodes ``t = x +
    residual`` and returns ``t - decode(wire)``, to be carried into the
    next round (zero for the lossless f32 wire)."""
    t = x.to(torch.float32) + residual
    wire = encode(t, dtype)
    return wire, t - decode(wire, dtype, torch.float32)
