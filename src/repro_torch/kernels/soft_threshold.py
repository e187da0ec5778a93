"""Fused ISTA step with shrinkage for Hopper — Algorithm 3 lines 5-7.

    a_new = S_t( a + gamma * (phi_y - gram_a) ),   S_t(z) = sign(z) max(|z| - t, 0)

in one pass over (..., eta, n) coefficient tensors — the hand-written CUDA
kernel ``csrc/ista_shrink.cu`` (replacing the JAX package's
`ista_shrink`).  It takes any n and any leading batch, and a threshold t
broadcastable to a as (eta, 1), (..., eta, 1) or per vertex (..., eta, n):
the kernel reads it through strides, so a per-scale threshold is never
expanded to the coefficients' size.

- :func:`ista_shrink`, the one-shot wrapper: checks every operand and
  writes a new tensor, or `out=` (which may be `a`).
- :func:`shrink_launcher`, an ISTA loop's launches against its fixed
  phi_y and threshold: checked, and the threshold table made, once per
  solve; each launch then checks a's and gram_a's shape and dtype and may
  write over a.

Both count in ``ista_shrink.launches``.  The launch shape (16-byte packs
where n and every pointer allow, a 2-D grid of vertex tiles and rows) is
`cheb_step.vector_launch`, decided in Python.

Dispatch: CPU tensors take the plain PyTorch version (`ista_shrink_plain`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from . import _build
from .cheb_step import vector_launch

Tensor = torch.Tensor

#: Rows of R x eta one launch takes (the kernel's row index is an int).
MAX_ROWS = 2**31 - 1


def ista_shrink_plain(a: Tensor, phi_y: Tensor, gram_a: Tensor,
                      thresh: Tensor, *, gamma: float,
                      out: Optional[Tensor] = None) -> Tensor:
    """``sign(z) * max(|z| - thresh, 0)`` with ``z = a + gamma (phi_y -
    gram_a)``; thresh broadcasts against a.  With `out` (which may be a)
    the result is written there and `out` returned."""
    z = a + gamma * (phi_y - gram_a)
    res = torch.sign(z) * torch.clamp_min(torch.abs(z) - thresh, 0.0)
    return res if out is None else out.copy_(res)


#: The C entry for each operand dtype (float64 serves reference plans run
#: on the card).
_ENTRIES = {torch.float32: "ista_shrink_f32",
            torch.float64: "ista_shrink_f64"}


class _ShrinkArgs(ctypes.Structure):
    """One launch's arguments (ista_shrink.cu: ShrinkArgs, field for
    field), passed by address."""

    _fields_ = ([(f, ctypes.c_void_p) for f in
                 ("a", "phi_y", "gram", "thresh", "out", "stream")]
                + [(f, ctypes.c_longlong) for f in
                   ("n", "t_batch_stride", "t_row_stride")]
                + [("gamma", ctypes.c_double)]
                + [(f, ctypes.c_int) for f in
                   ("rows", "eta", "per_vertex", "vec")]
                + [("gx", ctypes.c_uint), ("gy", ctypes.c_uint)])


def _lib(dtype: torch.dtype):
    lib = _build.library("ista_shrink")
    fn = getattr(lib, _ENTRIES[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
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
    col = 1 if tn == n and n > 1 else 0
    if thresh.shape[-2] == eta and thresh.is_contiguous():
        if all(d == 1 for d in thresh.shape[:-2]):   # one shared table
            return thresh, 0, tn, col
        if thresh.shape[:-2] == lead:
            return thresh, eta * tn, tn, col
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
    return table, batch_stride, tn, col


def shrink_launch(n: int, rows: int, ptrs, itemsize: int,
                  per_vertex: bool):
    """(vec, (gx, gy)) of a launch over `rows` rows of n elements:
    `cheb_step.vector_launch` over the pointers the kernel streams (a,
    phi_y, gram_a, out in `ptrs`, and the threshold table last, which
    counts only when it is `per_vertex`)."""
    return vector_launch(n, rows, ptrs if per_vertex else ptrs[:4],
                         itemsize)


def shrink_launcher(phi_y: Tensor, thresh, *,
                    gamma: float) -> Callable[..., Tensor]:
    """An ISTA loop's shrink launches against the fixed `phi_y` (..., eta,
    n) and threshold `thresh` (a tensor of phi_y's dtype and device,
    broadcastable to it as (eta, 1), (..., eta, 1) or (..., eta, n)),
    checked and the threshold table made once.  Returns ``launch(a,
    gram_a, out=None)``, which writes S_t(a + gamma (phi_y - gram_a)) into
    `out` (a new tensor when None; it may be `a`, contiguous) and returns
    it; it checks only a's and gram_a's shape and dtype and makes them
    contiguous.  On the CPU it runs the plain version."""
    if phi_y.device.type == "cpu":
        def launch_plain(a, gram_a, out=None):
            return ista_shrink_plain(a, phi_y, gram_a, thresh, gamma=gamma,
                                     out=out)

        return launch_plain
    if phi_y.device.type != "cuda":
        raise ValueError(f"ista_shrink runs on CUDA tensors, got "
                         f"{phi_y.device}")
    dt, dev, shape = phi_y.dtype, phi_y.device, phi_y.shape
    if dt not in _ENTRIES:
        raise TypeError("ista_shrink takes float32 (or float64) operands of "
                        "one dtype")
    if phi_y.ndim < 2:
        raise ValueError(f"ista_shrink shapes: phi_y {tuple(shape)} needs "
                         "(..., eta, n)")
    if thresh.device != dev or thresh.dtype != dt:
        raise TypeError("ista_shrink takes a threshold of phi_y's dtype on "
                        "its device")
    phi_y = phi_y.contiguous()
    table, tbs, trs, tcs = _threshold_operand(thresh, shape)
    eta, n = shape[-2], shape[-1]
    rows = math.prod(shape[:-2]) * eta
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows of R x eta exceed one launch's "
                         f"{MAX_ROWS}")
    per_vertex = tcs == 1
    lib, fn = _lib(dt)
    itemsize = phi_y.element_size()
    phi_ptr, table_ptr = phi_y.data_ptr(), table.data_ptr()
    args = _ShrinkArgs(phi_y=phi_ptr, thresh=table_ptr, n=n,
                       t_batch_stride=tbs, t_row_stride=trs,
                       gamma=float(gamma), rows=rows, eta=eta,
                       per_vertex=int(per_vertex))
    addr = ctypes.addressof(args)

    def launch(a, gram_a, out=None):
        if a.shape != shape or gram_a.shape != shape or a.dtype != dt \
                or gram_a.dtype != dt:
            raise ValueError(f"ista_shrink: a {tuple(a.shape)} {a.dtype}, "
                             f"gram_a {tuple(gram_a.shape)} {gram_a.dtype} "
                             f"against phi_y {tuple(shape)} {dt}")
        a, gram_a = a.contiguous(), gram_a.contiguous()
        if out is None:
            out = torch.empty_like(phi_y)
        if rows * n == 0:
            return out
        pa, pg, po = a.data_ptr(), gram_a.data_ptr(), out.data_ptr()
        args.vec, (args.gx, args.gy) = shrink_launch(
            n, rows, (pa, phi_ptr, pg, po, table_ptr), itemsize, per_vertex)
        args.a, args.gram, args.out = pa, pg, po
        args.stream = _build.current_stream(dev)
        with _build.device_scope(dev):
            err = fn(addr)
        if err:
            _build.check(lib, err, "ista_shrink")
        ista_shrink.launches += 1
        return out

    # the tensors the launches read through raw pointers stay alive with it
    launch.operands = (phi_y, table, args)
    return launch


def ista_shrink(a: Tensor, phi_y: Tensor, gram_a: Tensor, thresh: Tensor,
                *, gamma: float, out: Optional[Tensor] = None) -> Tensor:
    """One fused ISTA update with shrinkage.

    a, phi_y, gram_a: (..., eta, n), any n; thresh: broadcastable to a as
    (eta, 1), (..., eta, 1) or (..., eta, n).  The result is a new tensor,
    or written into `out` (a contiguous tensor of a's shape and dtype,
    which may be a itself, never phi_y or gram_a) and `out` returned.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/ista_shrink.cu`` (counted in ``ista_shrink.launches``).
    """
    if a.device.type == "cpu":
        return ista_shrink_plain(a, phi_y, gram_a, thresh, gamma=gamma,
                                 out=out)
    tensors = (a, phi_y, gram_a, thresh) + (() if out is None else (out,))
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
    if out is not None:
        if out.shape != a.shape or not out.is_contiguous():
            raise ValueError(f"ista_shrink out {tuple(out.shape)} must be a "
                             f"contiguous {tuple(a.shape)}")
        if out.data_ptr() in (phi_y.data_ptr(), gram_a.data_ptr()):
            raise ValueError("ista_shrink writes over a only, never phi_y "
                             "or gram_a")
    return shrink_launcher(phi_y, thresh, gamma=gamma)(a, gram_a, out)


ista_shrink.launches = 0
