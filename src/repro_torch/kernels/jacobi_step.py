"""Fused (accelerated-)Jacobi update for Hopper — Section V-A / V-B.

One round of the Section-V solvers after the matvec ``qx = Q @ x``:

    x_next = w * (x + D^{-1} (y - qx)) - s * x_prev

with ``w = 1, s = 0`` the plain Jacobi round (Eq. (24)) and the per-round
Chebyshev-accelerated weights of Eq. (25) otherwise — the hand-written
CUDA kernel ``csrc/jacobi_step.cu`` (replacing the JAX package's
`jacobi_step`).  It takes any n and any leading batch; y and inv_d may be
one unbatched (n,) row shared by the batch (read with a row stride of 0).
The per-round solver paths (`history=True`, the sweep guard's fallback,
`core.jacobi`) run it once per round.

Dispatch: CPU tensors take the plain PyTorch version (`jacobi_step_plain`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

Tensor = torch.Tensor


def jacobi_step_plain(qx: Tensor, x: Tensor, x_prev: Tensor, y: Tensor,
                      inv_d: Tensor, *, w, s) -> Tensor:
    """``w * (x + inv_d * (y - qx)) - s * x_prev``; y / inv_d broadcast
    against the (..., n) iterates."""
    return w * (x + inv_d * (y - qx)) - s * x_prev


#: The C entry and scalar type for each operand dtype (float64 serves
#: reference plans run on the card).
_ENTRIES = {torch.float32: ("jacobi_step_f32", ctypes.c_float),
            torch.float64: ("jacobi_step_f64", ctypes.c_double)}


def _lib(dtype: torch.dtype):
    lib = _build.library("jacobi_step")
    name, scalar = _ENTRIES[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4
                       + [scalar, scalar, ctypes.c_void_p])
    return lib, fn


def _row_operand(v: Tensor, shape, name: str):
    """(tensor, row stride) for y / inv_d: one shared (n,) row (stride 0)
    or a full batch (stride n); anything else broadcastable is expanded."""
    n = shape[-1]
    if v.shape == shape and v.is_contiguous():
        return v, n
    if v.numel() == n:
        return v.reshape(n).contiguous(), 0
    try:
        return v.expand(shape).contiguous(), n
    except RuntimeError:
        raise ValueError(f"jacobi_step: {name} {tuple(v.shape)} does not "
                         f"broadcast to {tuple(shape)}") from None


def jacobi_step(qx: Tensor, x: Tensor, x_prev: Tensor, y: Tensor,
                inv_d: Tensor, *, w, s) -> Tensor:
    """Returns ``w * (x + inv_d * (y - qx)) - s * x_prev`` as a new tensor.

    qx, x, x_prev: (..., n), any n; y, inv_d: (..., n) or a shared (n,)
    row (e.g. the reciprocal diagonal, zero on padded rows, which keeps
    those rows exactly zero).  w, s: Python scalars.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/jacobi_step.cu`` (counted in
    ``jacobi_step.launches``).
    """
    if x.device.type == "cpu":
        return jacobi_step_plain(qx, x, x_prev, y, inv_d, w=w, s=s)
    tensors = (qx, x, x_prev, y, inv_d)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi_step runs on CUDA tensors, got {x.device}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("jacobi_step operands must share one device")
    if x.dtype not in _ENTRIES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("jacobi_step takes float32 (or float64) operands of "
                        "one dtype")
    shape = x.shape
    if qx.shape != shape or x_prev.shape != shape:
        raise ValueError(f"jacobi_step shapes: qx {tuple(qx.shape)}, x "
                         f"{tuple(shape)}, x_prev {tuple(x_prev.shape)}")
    qx, x, x_prev = (t.contiguous() for t in (qx, x, x_prev))
    y, y_stride = _row_operand(y, shape, "y")
    inv_d, d_stride = _row_operand(inv_d, shape, "inv_d")
    n = shape[-1]
    B = math.prod(shape[:-1])
    out = torch.empty_like(x)
    if B * n == 0:
        return out
    lib, fn = _lib(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            qx.data_ptr(), x.data_ptr(), x_prev.data_ptr(), y.data_ptr(),
            inv_d.data_ptr(), out.data_ptr(), B, n, y_stride, d_stride,
            float(w), float(s), stream)
    _build.check(lib, err, "jacobi_step")
    jacobi_step.launches += 1
    return out


jacobi_step.launches = 0
