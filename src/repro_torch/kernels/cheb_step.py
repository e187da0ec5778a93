"""Chebyshev step for Hopper, in two instances.

One order of Algorithm 1:

    t_k   = (2/alpha) * P t_{k-1} - 2 * t_{k-1} - t_{k-2}   (line 9)
    acc_j += c_{j,k} * t_k   for every multiplier j       (line 12 running sum)

on (..., n) iterates and the (..., eta, n) accumulator, by the
hand-written CUDA kernel ``csrc/cheb_step.cu`` (replacing the JAX
package's `cheb_step`).  It takes any n; there is no lane-width padding.

- :func:`cheb_step`, the stand-alone instance, after a product
  ``pt = P t_{k-1}`` formed outside: an opaque matvec (the sharded
  exchange, gossip) in `ops._cheb_recurrence_loop`.  Counted in
  ``cheb_step.launches``.
- :func:`cheb_order`, the order instance: the sliced-ELL row product of
  t_{k-1} fused with the update, so ``pt`` never reaches memory; its
  first mode runs order 1 from x.  The per-order path on a local
  Block-ELL matvec (`ops.cheb_order_apply`) is K of these launches.
  Counted in ``cheb_order.launches``.

A loop of launches prepares them once (:func:`step_launcher`,
:func:`order_launcher`): device, dtype, shape and contiguity are checked,
the C entry and the stream resolved, and every launch after that passes
pointers only.  The public one-shot wrappers keep their checks.  Both
instances take outputs that alias inputs (`out=`), so a loop keeps one
accumulator and rotates two iterate buffers.  :func:`vector_launch` and
:func:`slice_launch` give the launch shapes (the stand-alone instance's
16-byte packs, the fused instance's signals per thread) that the kernels
are launched with.

Dispatch: CPU tensors take the plain PyTorch versions
(`cheb_step_plain`, `cheb_order_plain`); CUDA tensors launch the kernel
or raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.graph import SlicedELL
from . import _build
from .bcsr_spmv import _check_launch, sliced_ell_spmv_plain

Tensor = torch.Tensor

#: Threads per block of the stand-alone instances (cheb_step.cu,
#: jacobi_step.cu: kThreads).
STEP_THREADS = 256
#: Slices (warps) per block of the fused instances (sliced_ell_rows.cuh:
#: kWarps).
SLICE_WARPS = 4
MAX_GRID_Y = 65535
#: The most multipliers a launch takes: the order instance stages c_0 and
#: c_1 (2 eta floats) in shared memory in its first mode.
MAX_ETA = 4096


def vector_launch(n: int, rows: int, ptrs: Sequence[int],
                  itemsize: int) -> Tuple[int, Tuple[int, int]]:
    """(vec, (gx, gy)) of a stand-alone launch over `rows` signals of n
    elements: vec elements per access, 16 bytes (4 floats, 2 doubles)
    where n is a multiple of the pack and every pointer in `ptrs` is
    16-byte aligned, else 1; gx vertex tiles of STEP_THREADS * vec, gy
    signals (the kernel strides over any beyond MAX_GRID_Y)."""
    vec = 16 // itemsize
    if n % vec or any(p % 16 for p in ptrs):
        vec = 1
    return vec, (max(1, -(-n // (STEP_THREADS * vec))),
                 max(1, min(rows, MAX_GRID_Y)))


def slice_launch(n_slices: int, batch: int) -> Tuple[int, Tuple[int, int]]:
    """(tb, (gx, gy)) of a fused launch: tb signals per thread (8 from a
    batch of 16, 2 from 2, else 1: sliced_ell_spmv.cu's tiles), gx groups
    of SLICE_WARPS slices, gy signal tiles (strided beyond MAX_GRID_Y)."""
    tb = 8 if batch >= 16 else 2 if batch >= 2 else 1
    return tb, (max(1, -(-n_slices // SLICE_WARPS)),
                max(1, min(-(-batch // tb), MAX_GRID_Y)))


def cheb_step_plain(pt: Tensor, t_km1: Tensor, t_km2: Tensor, acc: Tensor,
                    coef: Tensor, *, alpha: float):
    """pt/t_km1/t_km2: (..., n); acc: (..., eta, n); coef: (eta,).
    Returns (t_k, acc + coef (x) t_k)."""
    tk = (2.0 / alpha) * pt - 2.0 * t_km1 - t_km2
    return tk, acc + coef[:, None] * tk[..., None, :]


def cheb_order_plain(S: SlicedELL, t_km1: Tensor, t_km2: Optional[Tensor],
                     acc: Optional[Tensor], coef: Tensor, *, alpha: float):
    """One order on a sliced-ELL P: `sliced_ell_spmv_plain` followed by
    `cheb_step_plain`, returning (t_k, acc + coef (x) t_k).  With
    ``t_km2=None`` order 1 from x = t_km1 and coef = (c_0, c_1) rows
    (2, eta): (t_1, c_0/2 (x) x + c_1 (x) t_1), t_1 = P x / alpha - x, and
    acc is not read."""
    pt = sliced_ell_spmv_plain(S, t_km1)
    if t_km2 is not None:
        return cheb_step_plain(pt, t_km1, t_km2, acc, coef, alpha=alpha)
    t1 = pt / alpha - t_km1
    return t1, (0.5 * coef[0][:, None] * t_km1[..., None, :]
                + coef[1][:, None] * t1[..., None, :])


#: The stand-alone C entry and scalar type for each operand dtype (float64
#: serves reference plans run on the card).
_ENTRIES = {torch.float32: ("cheb_step_f32", ctypes.c_float),
            torch.float64: ("cheb_step_f64", ctypes.c_double)}


def _step_fn(dtype: torch.dtype):
    lib = _build.library("cheb_step")
    name, scalar = _ENTRIES[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                          scalar, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_void_p])
    return lib, fn


def _order_fn():
    lib = _build.library("cheb_step")
    fn = lib.cheb_order_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                          ctypes.c_void_p])
    return lib, fn


def _check_eta(eta: int, what: str) -> None:
    if not 0 < eta <= MAX_ETA:
        raise ValueError(f"{what} takes 1 to {MAX_ETA} multipliers, got "
                         f"{eta}")


def _step_launch(like: Tensor, eta: int, *, alpha: float):
    """The stand-alone launch for operands already checked: iterates of
    `like`'s shape, dtype and device, an accumulator of `eta` rows."""
    n = like.shape[-1]
    B = math.prod(like.shape[:-1])
    lib, fn = _step_fn(like.dtype)
    stream = _build.current_stream(like.device)
    scope = _build.device_scope(like.device)
    scale = 2.0 / alpha
    itemsize = like.element_size()

    def launch(pt, t1, t2, coef, tk_out, acc_in, acc_out):
        ptrs = (pt.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                acc_in.data_ptr(), coef.data_ptr(), tk_out.data_ptr(),
                acc_out.data_ptr())
        vec, (gx, gy) = vector_launch(n, B, ptrs, itemsize)
        with scope:
            err = fn(*ptrs, B, n, eta, scale, vec, gx, gy, stream)
        if err:
            _build.check(lib, err, "cheb_step")
        cheb_step.launches += 1

    return launch


def step_launcher(like: Tensor, acc: Tensor, *,
                  alpha: float) -> Callable[..., None]:
    """A loop's stand-alone launches, checked once: `like` (..., n) gives
    the iterates' device, dtype and shape, `acc` (..., eta, n) the
    accumulator's.  Returns ``launch(pt, t_km1, t_km2, coef, tk_out,
    acc_in, acc_out)``, which writes t_k into tk_out and acc_in + coef (x)
    t_k into acc_out (either may alias its input) and checks nothing: the
    caller passes contiguous tensors of those shapes.  On the CPU the
    launch runs the plain version into the outputs."""
    if like.device.type == "cpu":
        def launch_plain(pt, t1, t2, coef, tk_out, acc_in, acc_out):
            tk, new_acc = cheb_step_plain(pt, t1, t2, acc_in, coef,
                                          alpha=alpha)
            tk_out.copy_(tk)
            acc_out.copy_(new_acc)

        return launch_plain
    if like.device.type != "cuda":
        raise ValueError(f"cheb_step runs on CUDA tensors, got {like.device}")
    if like.dtype not in _ENTRIES or acc.dtype != like.dtype \
            or acc.device != like.device:
        raise TypeError("cheb_step takes float32 (or float64) operands of "
                        "one dtype on one device")
    eta = acc.shape[-2] if acc.ndim >= 2 else 0
    _check_eta(eta, "cheb_step")
    if acc.shape != like.shape[:-1] + (eta, like.shape[-1]):
        raise ValueError(f"cheb_step shapes: iterates {tuple(like.shape)}, "
                         f"acc {tuple(acc.shape)}")
    return _step_launch(like, eta, alpha=alpha)


def cheb_step(pt: Tensor, t_km1: Tensor, t_km2: Tensor, acc: Tensor,
              coef: Tensor, *, alpha: float,
              out: Optional[Tuple[Tensor, Tensor]] = None):
    """Returns (t_k, acc + outer(coef, t_k)).

    pt, t_km1, t_km2: (..., n), any n; acc: (..., eta, n); coef: (eta,).
    out: an optional (tk_out, acc_out) pair the results are written into
    and returned, contiguous, of t_k's and acc's shapes: tk_out may be
    t_km2 (t_k written over t_{k-2}) and acc_out acc (updated in place);
    without it both are new tensors.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/cheb_step.cu``'s stand-alone instance
    (counted in ``cheb_step.launches``).
    """
    if pt.device.type == "cpu":
        if out is None:
            return cheb_step_plain(pt, t_km1, t_km2, acc, coef, alpha=alpha)
        tk_out, acc_out = out
        step_launcher(pt, acc, alpha=alpha)(pt, t_km1, t_km2, coef, tk_out,
                                            acc, acc_out)
        return out
    dev, dt = pt.device, pt.dtype
    if dev.type != "cuda":
        raise ValueError(f"cheb_step runs on CUDA tensors, got {dev}")
    if dt not in _ENTRIES:
        raise TypeError("cheb_step takes float32 (or float64) operands")
    for t in (t_km1, t_km2, acc, coef) + tuple(out or ()):
        if t.device != dev or t.dtype != dt:
            raise TypeError("cheb_step takes operands of one dtype on one "
                            "device")
        if not t.is_contiguous():
            raise ValueError("cheb_step takes contiguous tensors")
    if not pt.is_contiguous():
        raise ValueError("cheb_step takes contiguous tensors")
    shape = pt.shape
    eta = coef.shape[0] if coef.ndim == 1 else 0
    acc_shape = shape[:-1] + (eta, shape[-1])
    if (coef.ndim != 1 or t_km1.shape != shape or t_km2.shape != shape
            or acc.shape != acc_shape
            or (out is not None and (len(out) != 2 or out[0].shape != shape
                                     or out[1].shape != acc_shape))):
        raise ValueError(
            f"cheb_step shapes: pt {tuple(shape)}, t_km1 "
            f"{tuple(t_km1.shape)}, t_km2 {tuple(t_km2.shape)}, acc "
            f"{tuple(acc.shape)}, coef {tuple(coef.shape)}"
            + ("" if out is None else
               f", out {[tuple(t.shape) for t in out]}"))
    _check_eta(eta, "cheb_step")
    tk, acc_out = out if out is not None else (torch.empty_like(pt),
                                                torch.empty_like(acc))
    if pt.numel() == 0:
        return tk, acc_out
    _step_launch(pt, eta, alpha=alpha)(pt, t_km1, t_km2, coef, tk, acc,
                                       acc_out)
    return tk, acc_out


cheb_step.launches = 0


def order_launcher(S: SlicedELL, x: Tensor, eta: int, *,
                   alpha: float) -> Callable[..., None]:
    """A loop's order launches on the square sliced-ELL P `S`, checked
    once: `x` (..., padded_n) gives the iterates' device, dtype and shape,
    `eta` the accumulator's (..., eta, padded_n).  Returns ``launch(t_km1,
    t_km2, coef, tk_out, acc_in, acc_out)`` (order k >= 2, coef = c_k
    (eta,); tk_out may alias t_km2 and acc_out acc_in, neither may alias
    t_km1), or, with ``t_km2=None``, order 1 from x = t_km1 and coef =
    (c_0, c_1) rows (2, eta), acc_in not read.  A launch checks nothing:
    the caller passes contiguous tensors of those shapes.  On the CPU it
    runs the plain version into the outputs."""
    if x.device.type == "cpu":
        def launch_plain(t1, t2, coef, tk_out, acc_in, acc_out):
            tk, new_acc = cheb_order_plain(S, t1, t2, acc_in, coef,
                                           alpha=alpha)
            tk_out.copy_(tk)
            acc_out.copy_(new_acc)

        return launch_plain
    _check_launch(S, x, "cheb_order")
    if S.n_cols is not None:
        raise ValueError("cheb_order takes a square layout")
    _check_eta(eta, "cheb_order")
    n = S.padded_n
    B = math.prod(x.shape[:-1])
    if B >= 2**31 // 16:
        raise ValueError(f"batch {B} too large for one launch")
    lib, fn = _order_fn()
    tb, (gx, gy) = slice_launch(S.n_slices, B)
    stream = _build.current_stream(x.device)
    scope = _build.device_scope(x.device)
    layout = (S.values.data_ptr(), S.columns.data_ptr(),
              S.offsets.data_ptr(), S.widths.data_ptr())
    n_slices = S.n_slices
    inv_alpha, two_over_alpha = 1.0 / alpha, 2.0 / alpha

    def launch(t1, t2, coef, tk_out, acc_in, acc_out):
        first = t2 is None
        with scope:
            err = fn(*layout, t1.data_ptr(), None if first else t2.data_ptr(),
                     tk_out.data_ptr(), acc_in.data_ptr(),
                     acc_out.data_ptr(), coef.data_ptr(), n_slices, n, B,
                     eta, inv_alpha if first else two_over_alpha, int(first),
                     tb, gx, gy, stream)
        if err:
            _build.check(lib, err, "cheb_order")
        cheb_order.launches += 1

    return launch


def cheb_order(S: SlicedELL, t_km1: Tensor, t_km2: Optional[Tensor],
               acc: Optional[Tensor], coef: Tensor, *, alpha: float,
               out: Optional[Tuple[Tensor, Tensor]] = None):
    """One order of Algorithm 1 on a square sliced-ELL P in one launch:
    returns (t_k, acc + outer(c_k, t_k)) with t_k = (2/alpha) P t_{k-1} -
    2 t_{k-1} - t_{k-2}, or, with ``t_km2=None``, order 1 from x = t_km1:
    (t_1, outer(c_0, x) / 2 + outer(c_1, t_1)), t_1 = P x / alpha - x,
    coef = (c_0, c_1) rows (2, eta) and acc not read (may be None).

    t_km1, t_km2: (..., padded_n) float32; acc: (..., eta, padded_n);
    coef: (eta,) or (2, eta).  out: an optional (tk_out, acc_out) pair, as
    in :func:`cheb_step`; tk_out must not be t_km1, which the product
    reads while the launch writes.  CPU tensors take `cheb_order_plain`;
    CUDA tensors launch ``csrc/cheb_step.cu``'s order instance (counted
    in ``cheb_order.launches``).
    """
    first = t_km2 is None
    eta = coef.shape[-1]
    if t_km1.device.type == "cpu":
        if out is None:
            return cheb_order_plain(S, t_km1, t_km2, acc, coef, alpha=alpha)
        order_launcher(S, t_km1, eta, alpha=alpha)(
            t_km1, t_km2, coef, out[0], out[1] if first else acc, out[1])
        return out
    _check_launch(S, t_km1, "cheb_order")
    acc_shape = t_km1.shape[:-1] + (eta, t_km1.shape[-1])
    tensors = ((t_km1, coef) + (() if first else (t_km2, acc))
               + tuple(out or ()))
    if any(t.device != t_km1.device or t.dtype != torch.float32
           for t in tensors):
        raise TypeError("cheb_order takes float32 operands on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cheb_order takes contiguous tensors")
    if (coef.shape != ((2, eta) if first else (eta,))
            or (not first and (t_km2.shape != t_km1.shape
                               or acc.shape != acc_shape))
            or (out is not None and (len(out) != 2
                                     or out[0].shape != t_km1.shape
                                     or out[1].shape != acc_shape))):
        raise ValueError(
            f"cheb_order shapes: t_km1 {tuple(t_km1.shape)}, t_km2 "
            f"{None if first else tuple(t_km2.shape)}, acc "
            f"{None if acc is None else tuple(acc.shape)}, coef "
            f"{tuple(coef.shape)}")
    if out is not None and out[0].data_ptr() == t_km1.data_ptr():
        raise ValueError("cheb_order cannot write t_k over t_km1, which "
                         "its product reads")
    tk, acc_out = out if out is not None else (
        torch.empty_like(t_km1),
        torch.empty(acc_shape, dtype=t_km1.dtype, device=t_km1.device))
    if t_km1.numel() == 0:
        return tk, acc_out
    order_launcher(S, t_km1, eta, alpha=alpha)(
        t_km1, t_km2, coef, tk, acc_out if first else acc, acc_out)
    return tk, acc_out


cheb_order.launches = 0
