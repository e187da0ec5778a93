"""Selective SSM (S6 / mamba) branch of the hymba hybrid layers (the JAX
package's `models/mamba.py`):

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t
    y_t = C_t . h_t + D x_t,            dt_t, B_t, C_t input-dependent.

The state carried per layer: h (B, d_in, ssm_state), f32, and the
depthwise convolution's tail (B, conv_width - 1, d_in) — O(1) in the
sequence length.

Roundings follow the JAX package: the convolution accumulates tap by tap
in the model dtype; dA is formed in f32, dt x B in the model dtype and
only then widened; the recurrence runs in f32 (a Python loop over the
sequence, where the JAX package scans).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 tail: Tensor) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d.  x (B, S, d_in); w (cw, d_in); tail
    (B, cw - 1, d_in), the inputs before x.  Returns (out, the last cw - 1
    inputs)."""
    cw = w.shape[0]
    S = x.shape[1]
    xin = torch.cat([tail.to(x.dtype), x], dim=1)           # (B, S+cw-1, d)
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xin[:, i:i + S, :] * w[i][None, None, :]
    new_tail = xin[:, xin.shape[1] - (cw - 1):, :] if cw > 1 else tail
    return out + b, new_tail


def ssm_branch(x: Tensor, p: Dict, state: Tuple[Tensor, Tensor],
               ssm_state: int) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """x: (B, S, D) normed input; state (h (B, d_in, st), conv_tail).
    Returns (y (B, S, D), (h, conv_tail)), the state new tensors."""
    h0, conv_tail = state
    st = ssm_state
    silu = torch.nn.functional.silu

    xp, z = (x @ p["w_in"]).chunk(2, dim=-1)                 # (B, S, d_in)
    xc, new_tail = _causal_conv(xp, p["conv_w"], p["conv_b"], conv_tail)
    xc = silu(xc)

    bcdt = xc @ p["w_bcdt"]                                  # (B,S,2st+dtr)
    bmat = bcdt[..., :st]
    cmat = bcdt[..., st:2 * st].float()
    dt = torch.nn.functional.softplus(bcdt[..., 2 * st:] @ p["w_dt"]
                                      + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())                       # (d_in, st)

    dA = torch.exp(dt[..., None].float() * A)                # (B,S,d_in,st)
    dBx = ((dt * xc)[..., None] * bmat[:, :, None, :]).float()

    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                   # (B, S, d_in)
    y = y + p["D_skip"] * xc
    y = y * silu(z)
    return y @ p["w_ssm_out"], (h.to(h0.dtype), new_tail)


def init_state(cfg, batch: int, dtype: torch.dtype, device) -> Dict:
    d_in = cfg.ssm_expand * cfg.d_model
    L = cfg.n_layers
    return {
        "ssm_h": torch.zeros((L, batch, d_in, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((L, batch, cfg.conv_width - 1, d_in),
                                 dtype=dtype, device=device),
    }
