"""(Accelerated-)Jacobi round for Hopper — Section V-A / V-B, in two
instances.

One round of the Section-V solvers:

    x_next = w * (x + D^{-1} (y - q)) - s * x_prev

with ``w = 1, s = 0`` the plain Jacobi round (Eq. (24)) and the per-round
Chebyshev-accelerated weights of Eq. (25) otherwise, by the hand-written
CUDA kernel ``csrc/jacobi_step.cu`` (replacing the JAX package's
`jacobi_step`).  It takes any n and any leading batch; y and inv_d may be
one unbatched (n,) row shared by the batch, read with a row stride of 0
and never expanded.

- :func:`jacobi_step`, the stand-alone instance, after a product
  ``q = Q x`` formed outside (an opaque matvec: `core.jacobi` over the
  sharded exchange).  Counted in ``jacobi_step.launches``.
- :func:`jacobi_round`, the round instance: the last Horner step
  ``q = a * (P h) + c0 * x`` on a sliced-ELL P fused with the update, the
  product of h never reaching memory.  With deg(den) = 1, h = x and
  a = den[1], so a round of the per-round path (`ops._per_round_jacobi`:
  ``history=True``, the sweep guard's fallback) is one launch.  Counted in
  ``jacobi_round.launches``.

The per-round loop prepares its launches once (:func:`round_launcher`);
the public one-shot wrappers keep their checks.  The output may be
x_prev's buffer (`out=`), so a loop rotates two iterate buffers.

Dispatch: CPU tensors take the plain PyTorch versions
(`jacobi_step_plain`, `jacobi_round_plain`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from ..core.graph import SlicedELL
from . import _build
from .bcsr_spmv import _check_launch, sliced_ell_spmv_plain
from .cheb_step import slice_launch, vector_launch

Tensor = torch.Tensor


def jacobi_step_plain(qx: Tensor, x: Tensor, x_prev: Tensor, y: Tensor,
                      inv_d: Tensor, *, w, s) -> Tensor:
    """``w * (x + inv_d * (y - qx)) - s * x_prev``; y / inv_d broadcast
    against the (..., n) iterates."""
    return w * (x + inv_d * (y - qx)) - s * x_prev


def jacobi_round_plain(S: SlicedELL, h: Tensor, x: Tensor, x_prev: Tensor,
                       y: Tensor, inv_d: Tensor, *, a, c0, w, s) -> Tensor:
    """One round on a sliced-ELL P: ``q = a * (P h) + c0 * x`` by
    `sliced_ell_spmv_plain`, then `jacobi_step_plain`."""
    q = a * sliced_ell_spmv_plain(S, h) + c0 * x
    return jacobi_step_plain(q, x, x_prev, y, inv_d, w=w, s=s)


#: The stand-alone C entry and scalar type for each operand dtype (float64
#: serves reference plans run on the card).
_ENTRIES = {torch.float32: ("jacobi_step_f32", ctypes.c_float),
            torch.float64: ("jacobi_step_f64", ctypes.c_double)}


def _step_fn(dtype: torch.dtype):
    lib = _build.library("jacobi_step")
    name, scalar = _ENTRIES[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4
                       + [scalar, scalar, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_uint, ctypes.c_void_p])
    return lib, fn


def _round_fn():
    lib = _build.library("jacobi_step")
    fn = lib.jacobi_round_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_float] * 4
                       + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_void_p])
    return lib, fn


def _row_operand(v: Tensor, shape, name: str):
    """(tensor, row stride) for y / inv_d as the kernels read them: a full
    batch of `shape` (stride n) or one shared (n,) row (stride 0), made
    contiguous (a copy only for a strided view); never expanded, and any
    other shape raises."""
    n = shape[-1]
    if v.shape == shape:
        return v.contiguous(), n
    if v.numel() == n and v.shape[-1] == n:
        return v.reshape(n).contiguous(), 0
    raise ValueError(f"jacobi_step: {name} {tuple(v.shape)} is neither a "
                     f"{tuple(shape)} batch nor one ({n},) row")


def jacobi_step(qx: Tensor, x: Tensor, x_prev: Tensor, y: Tensor,
                inv_d: Tensor, *, w, s,
                out: Optional[Tensor] = None) -> Tensor:
    """Returns ``w * (x + inv_d * (y - qx)) - s * x_prev``.

    qx, x, x_prev: (..., n), any n; y, inv_d: (..., n) or a shared (n,)
    row (e.g. the reciprocal diagonal, zero on padded rows, which keeps
    those rows exactly zero).  w, s: Python scalars.  out: an
    optional contiguous (..., n) tensor written and returned (it may be
    x_prev's buffer); without it a new tensor.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/jacobi_step.cu``'s
    stand-alone instance (counted in ``jacobi_step.launches``).
    """
    if x.device.type == "cpu":
        got = jacobi_step_plain(qx, x, x_prev, y, inv_d, w=w, s=s)
        return got if out is None else out.copy_(got)
    dev, dt, shape = x.device, x.dtype, x.shape
    if dev.type != "cuda":
        raise ValueError(f"jacobi_step runs on CUDA tensors, got {dev}")
    if dt not in _ENTRIES:
        raise TypeError("jacobi_step takes float32 (or float64) operands")
    for t in (qx, x_prev, y, inv_d) + (() if out is None else (out,)):
        if t.device != dev or t.dtype != dt:
            raise TypeError("jacobi_step takes operands of one dtype on one "
                            "device")
    if qx.shape != shape or x_prev.shape != shape or (
            out is not None and (out.shape != shape
                                 or not out.is_contiguous())):
        raise ValueError(f"jacobi_step shapes: qx {tuple(qx.shape)}, x "
                         f"{tuple(shape)}, x_prev {tuple(x_prev.shape)}"
                         + ("" if out is None
                            else f", out {tuple(out.shape)}"))
    qx, x, x_prev = qx.contiguous(), x.contiguous(), x_prev.contiguous()
    y, y_stride = _row_operand(y, shape, "y")
    inv_d, d_stride = _row_operand(inv_d, shape, "inv_d")
    out = torch.empty_like(x) if out is None else out
    n = shape[-1]
    B = math.prod(shape[:-1])
    if B * n == 0:
        return out
    lib, fn = _step_fn(dt)
    ptrs = (qx.data_ptr(), x.data_ptr(), x_prev.data_ptr(), y.data_ptr(),
            inv_d.data_ptr(), out.data_ptr())
    vec, (gx, gy) = vector_launch(n, B, ptrs, x.element_size())
    with _build.device_scope(dev):
        err = fn(*ptrs, B, n, y_stride, d_stride, float(w), float(s), vec,
                 gx, gy, _build.current_stream(dev))
    if err:
        _build.check(lib, err, "jacobi_step")
    jacobi_step.launches += 1
    return out


jacobi_step.launches = 0


def round_launcher(S: SlicedELL, x: Tensor, y: Tensor,
                   inv_d: Tensor) -> Callable[..., None]:
    """A loop's round launches on the square sliced-ELL P `S`, checked
    once: `x` (..., padded_n) gives the iterates' device, dtype and shape;
    y and inv_d, each a batch of that shape or one shared (padded_n,) row,
    are bound here.  Returns ``launch(h, x, x_prev, out, a, c0, w, s)``,
    which writes the round into `out` (it may be x_prev's buffer, never h
    or x) and checks nothing: the caller passes contiguous tensors of x's
    shape.  On the CPU it runs the plain version into `out`."""
    if x.device.type == "cpu":
        def launch_plain(h, xv, x_prev, out, a, c0, w, s):
            out.copy_(jacobi_round_plain(S, h, xv, x_prev, y, inv_d, a=a,
                                         c0=c0, w=w, s=s))

        return launch_plain
    _check_launch(S, x, "jacobi_round")
    if S.n_cols is not None:
        raise ValueError("jacobi_round takes a square layout")
    if any(t.device != x.device or t.dtype != torch.float32
           for t in (y, inv_d)):
        raise TypeError("jacobi_round takes float32 operands on one device")
    shape = x.shape
    y, y_stride = _row_operand(y, shape, "y")
    inv_d, d_stride = _row_operand(inv_d, shape, "inv_d")
    n = S.padded_n
    B = math.prod(shape[:-1])
    if B >= 2**31 // 16:
        raise ValueError(f"batch {B} too large for one launch")
    lib, fn = _round_fn()
    tb, (gx, gy) = slice_launch(S.n_slices, B)
    stream = _build.current_stream(x.device)
    scope = _build.device_scope(x.device)
    head = (S.values.data_ptr(), S.columns.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr())
    rows = (y.data_ptr(), inv_d.data_ptr())
    n_slices = S.n_slices

    def launch(h, xv, x_prev, out, a, c0, w, s):
        with scope:
            err = fn(*head, h.data_ptr(), xv.data_ptr(), x_prev.data_ptr(),
                     *rows, out.data_ptr(), n_slices, n, B, y_stride,
                     d_stride, a, c0, w, s, tb, gx, gy, stream)
        if err:
            _build.check(lib, err, "jacobi_round")
        jacobi_round.launches += 1

    return launch


def jacobi_round(S: SlicedELL, h: Tensor, x: Tensor, x_prev: Tensor,
                 y: Tensor, inv_d: Tensor, *, a, c0, w, s,
                 out: Optional[Tensor] = None) -> Tensor:
    """One Jacobi round on a square sliced-ELL P in one launch:
    ``q = a * (P h) + c0 * x``, then ``w * (x + inv_d * (y - q)) - s *
    x_prev``.

    h, x, x_prev: (..., padded_n) float32 (h may be x); y, inv_d as in
    :func:`jacobi_step`.  a, c0, w, s: Python scalars.  out: an optional
    contiguous tensor of x's shape, written and returned (it may be
    x_prev's buffer, not h's or x's: the product reads them while the
    launch writes).  CPU tensors take `jacobi_round_plain`; CUDA tensors
    launch ``csrc/jacobi_step.cu``'s round instance (counted in
    ``jacobi_round.launches``).
    """
    if x.device.type == "cpu":
        got = jacobi_round_plain(S, h, x, x_prev, y, inv_d, a=a, c0=c0, w=w,
                                 s=s)
        return got if out is None else out.copy_(got)
    _check_launch(S, x, "jacobi_round")
    tensors = (h, x_prev) + (() if out is None else (out,))
    if any(t.device != x.device or t.dtype != torch.float32
           or t.shape != x.shape or not t.is_contiguous() for t in tensors):
        raise ValueError(f"jacobi_round takes contiguous float32 h, x_prev "
                         f"and out of x's shape {tuple(x.shape)} on its "
                         f"device")
    if out is not None and out.data_ptr() in (h.data_ptr(), x.data_ptr()):
        raise ValueError("jacobi_round cannot write over h or x, which its "
                         "product reads")
    out = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return out
    round_launcher(S, x, y, inv_d)(h, x, x_prev, out, float(a), float(c0),
                                   float(w), float(s))
    return out


jacobi_round.launches = 0
