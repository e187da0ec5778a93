"""Fused ISTA step with shrinkage for Hopper — Algorithm 3 lines 5-7.

    a_new = S_t( a + gamma * (phi_y - gram_a) ),   S_t(z) = sign(z) max(|z| - t, 0)

in one pass over (..., eta, n) coefficient tensors — the hand-written CUDA
kernel ``csrc/ista_shrink.cu`` (replacing the JAX package's
`ista_shrink`).  It takes any n and any leading batch, and a threshold t
broadcastable to a as (eta, 1), (..., eta, 1) or per vertex (..., eta, n):
the kernel reads it through strides, so a per-scale threshold is never
expanded to the coefficients' size.

Dispatch: CPU tensors take the plain PyTorch version (`ista_shrink_plain`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

Tensor = torch.Tensor


def ista_shrink_plain(a: Tensor, phi_y: Tensor, gram_a: Tensor,
                      thresh: Tensor, *, gamma: float) -> Tensor:
    """``sign(z) * max(|z| - thresh, 0)`` with ``z = a + gamma (phi_y -
    gram_a)``; thresh broadcasts against a."""
    z = a + gamma * (phi_y - gram_a)
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - thresh, 0.0)


#: The C entry and scalar type for each operand dtype (float64 serves
#: reference plans run on the card).
_ENTRIES = {torch.float32: ("ista_shrink_f32", ctypes.c_float),
            torch.float64: ("ista_shrink_f64", ctypes.c_double)}


def _lib(dtype: torch.dtype):
    lib = _build.library("ista_shrink")
    name, scalar = _ENTRIES[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_longlong] * 4
                       + [scalar, ctypes.c_void_p])
    return lib, fn


def _threshold_operand(thresh: Tensor, shape):
    """(tensor, batch stride, row stride, column stride) that reads
    `thresh` as broadcast to ``shape = lead + (eta, n)`` without expanding
    it: a threshold shared by the leading batch gets batch stride 0, a
    per-row one column stride 0.  Leading dims that broadcast only in part
    are expanded over the leading dims alone."""
    eta, n = shape[-2], shape[-1]
    lead = shape[:-2]
    if thresh.ndim < 2:
        thresh = thresh.reshape((1,) * (2 - thresh.ndim) + thresh.shape)
    tn = thresh.shape[-1]
    if tn not in (1, n) or thresh.shape[-2] not in (1, eta):
        raise ValueError(f"threshold {tuple(thresh.shape)} does not "
                         f"broadcast to {tuple(shape)}")
    table = thresh.expand(thresh.shape[:-2] + (eta, tn))
    if math.prod(table.shape[:-2]) == 1:
        table = table.reshape(eta, tn).contiguous()
        batch_stride = 0
    else:
        try:
            table = table.expand(lead + (eta, tn)).contiguous()
        except RuntimeError:
            raise ValueError(f"threshold {tuple(thresh.shape)} does not "
                             f"broadcast to {tuple(shape)}") from None
        batch_stride = eta * tn
    return table, batch_stride, tn, 1 if tn == n and n > 1 else 0


def ista_shrink(a: Tensor, phi_y: Tensor, gram_a: Tensor, thresh: Tensor,
                *, gamma: float) -> Tensor:
    """One fused ISTA update with shrinkage, as a new tensor.

    a, phi_y, gram_a: (..., eta, n), any n; thresh: broadcastable to a as
    (eta, 1), (..., eta, 1) or (..., eta, n).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/ista_shrink.cu`` (counted in
    ``ista_shrink.launches``).
    """
    if a.device.type == "cpu":
        return ista_shrink_plain(a, phi_y, gram_a, thresh, gamma=gamma)
    tensors = (a, phi_y, gram_a, thresh)
    if a.device.type != "cuda":
        raise ValueError(f"ista_shrink runs on CUDA tensors, got {a.device}")
    if any(t.device != a.device for t in tensors):
        raise ValueError("ista_shrink operands must share one device")
    if a.dtype not in _ENTRIES or any(t.dtype != a.dtype for t in tensors):
        raise TypeError("ista_shrink takes float32 (or float64) operands of "
                        "one dtype")
    if a.ndim < 2 or phi_y.shape != a.shape or gram_a.shape != a.shape:
        raise ValueError(f"ista_shrink shapes: a {tuple(a.shape)}, phi_y "
                         f"{tuple(phi_y.shape)}, gram_a "
                         f"{tuple(gram_a.shape)}")
    a, phi_y, gram_a = (t.contiguous() for t in (a, phi_y, gram_a))
    table, tbs, trs, tcs = _threshold_operand(thresh, a.shape)
    eta, n = a.shape[-2], a.shape[-1]
    R = math.prod(a.shape[:-2])
    out = torch.empty_like(a)
    if R * eta * n == 0:
        return out
    lib, fn = _lib(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            a.data_ptr(), phi_y.data_ptr(), gram_a.data_ptr(),
            table.data_ptr(), out.data_ptr(), R, eta, n, tbs, trs, tcs,
            float(gamma), stream)
    _build.check(lib, err, "ista_shrink")
    ista_shrink.launches += 1
    return out


ista_shrink.launches = 0
