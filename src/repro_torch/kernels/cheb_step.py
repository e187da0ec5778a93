"""Fused Chebyshev recurrence step for Hopper.

One order of Algorithm 1 after the sparse matvec ``pt = P @ t_{k-1}``:

    t_k   = (2/alpha) * pt - 2 * t_{k-1} - t_{k-2}      (line 9)
    acc_j += c_{j,k} * t_k   for every multiplier j       (line 12 running sum)

in one pass over (..., n) iterates and the (..., eta, n) accumulator —
the hand-written CUDA kernel ``csrc/cheb_step.cu`` (replacing the JAX
package's `cheb_step`).  It takes any n; there is no lane-width padding.
The per-order recurrence (`ops._cheb_recurrence_loop`) runs it once per
order when the whole-recurrence sweep is not taken.

Dispatch: CPU tensors take the plain PyTorch version (`cheb_step_plain`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

Tensor = torch.Tensor


def cheb_step_plain(pt: Tensor, t_km1: Tensor, t_km2: Tensor, acc: Tensor,
                    coef: Tensor, *, alpha: float):
    """pt/t_km1/t_km2: (..., n); acc: (..., eta, n); coef: (eta,).
    Returns (t_k, acc + coef (x) t_k)."""
    tk = (2.0 / alpha) * pt - 2.0 * t_km1 - t_km2
    return tk, acc + coef[:, None] * tk[..., None, :]


#: The C entry and scalar type for each operand dtype (float64 serves
#: reference plans run on the card).
_ENTRIES = {torch.float32: ("cheb_step_f32", ctypes.c_float),
            torch.float64: ("cheb_step_f64", ctypes.c_double)}


def _lib(dtype: torch.dtype):
    lib = _build.library("cheb_step")
    name, scalar = _ENTRIES[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          scalar, ctypes.c_void_p])
    return lib, fn


def cheb_step(pt: Tensor, t_km1: Tensor, t_km2: Tensor, acc: Tensor,
              coef: Tensor, *, alpha: float):
    """Returns (t_k, acc + outer(coef, t_k)) as new tensors.

    pt, t_km1, t_km2: (..., n), any n; acc: (..., eta, n); coef: (eta,).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/cheb_step.cu`` (counted in ``cheb_step.launches``).
    """
    if pt.device.type == "cpu":
        return cheb_step_plain(pt, t_km1, t_km2, acc, coef, alpha=alpha)
    tensors = (pt, t_km1, t_km2, acc, coef)
    if pt.device.type != "cuda":
        raise ValueError(f"cheb_step runs on CUDA tensors, got {pt.device}")
    if any(t.device != pt.device for t in tensors):
        raise ValueError("cheb_step operands must share one device")
    if pt.dtype not in _ENTRIES or any(t.dtype != pt.dtype
                                       for t in tensors):
        raise TypeError("cheb_step takes float32 (or float64) operands of "
                        "one dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cheb_step takes contiguous tensors")
    eta = coef.shape[0]
    if (coef.ndim != 1 or t_km1.shape != pt.shape or t_km2.shape != pt.shape
            or acc.shape != pt.shape[:-1] + (eta, pt.shape[-1])):
        raise ValueError(
            f"cheb_step shapes: pt {tuple(pt.shape)}, t_km1 "
            f"{tuple(t_km1.shape)}, t_km2 {tuple(t_km2.shape)}, acc "
            f"{tuple(acc.shape)}, coef {tuple(coef.shape)}")
    n = pt.shape[-1]
    B = math.prod(pt.shape[:-1])
    tk = torch.empty_like(pt)
    acc_out = torch.empty_like(acc)
    if B * n == 0:
        return tk, acc_out
    lib, fn = _lib(pt.dtype)
    with torch.cuda.device(pt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            pt.data_ptr(), t_km1.data_ptr(), t_km2.data_ptr(),
            acc.data_ptr(), coef.data_ptr(), tk.data_ptr(),
            acc_out.data_ptr(), B, n, eta, 2.0 / alpha, stream)
    _build.check(lib, err, "cheb_step")
    cheb_step.launches += 1
    return tk, acc_out


cheb_step.launches = 0
