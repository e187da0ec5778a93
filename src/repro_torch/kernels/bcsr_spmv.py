"""Sparse matvec — the Algorithm 1 hot loop — for Hopper.

The paper's per-order cost is one sparse matvec with P (Section IV-A).
The JAX package stores P in Block-ELL for the TPU's (8, 128) tiles; on a
strip-sorted sensor graph that layout stores ~40 entries per non-zero.
The card's SpMV reads the sliced-ELL row layout instead
(`core.graph.SlicedELL`: slices of 32 rows, each as wide as its widest
row, ~1.4 stored entries per non-zero).  `sliced_ell_spmv` is one wrapper
for any batch: Y = A X^T on (..., padded_n) signals, by the hand-written
CUDA kernel ``csrc/sliced_ell_spmv.cu``, which replaces both
`block_ell_spmv` and `block_ell_spmv_batched` of the JAX package.

The Block-ELL plain version (`block_ell_spmv_plain`) stays as the bridge
the parity tests hold against the JAX kernels.  The whole-iteration
sweeps (`kernels/cheb_sweep.py`) read the same sliced layout.

`sliced_ell_spmv_accumulate` launches the same kernel on a rectangular
layout in its accumulating mode, Y += C R: the couplings of a general
partition's shard (`dist/sharded.py`), which the JAX package scattered
with ``y.at[rows].add`` around its Block-ELL SpMV.  It counts its own
launches.

Dispatch: a tensor on the CPU takes the plain PyTorch version
(`sliced_ell_spmv_plain`); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..core.graph import SLICE_ROWS, SlicedELL
from . import _build

Tensor = torch.Tensor


def block_ell_spmv_plain(blocks: Tensor, indices: Tensor, x: Tensor) -> Tensor:
    """y = A @ x in plain PyTorch; blocks (nrb, slots, br, bc), indices
    (nrb, slots), x (..., ncb * bc) with any leading batch dims.  Padded
    slots must hold zero blocks."""
    nrb, slots, br, bc = blocks.shape
    lead = x.shape[:-1]
    xb = x.reshape(lead + (-1, bc))
    gathered = xb.index_select(-2, indices.reshape(-1).long())
    gathered = gathered.reshape(lead + (nrb, slots, bc))
    y = torch.einsum("rsij,...rsj->...ri", blocks, gathered)
    return y.reshape(lead + (nrb * br,))


def sliced_ell_spmv_plain(S: SlicedELL, x: Tensor,
                          values: Optional[Tensor] = None, *,
                          out: Optional[Tensor] = None) -> Tensor:
    """y = A @ x in plain PyTorch for sliced-ELL A and x (..., A.x_len)
    with any leading batch dims: every stored entry's product gathered,
    then summed into its row (padding entries add 0).  A may be
    rectangular (`SlicedELL.n_cols` columns); the result has A's
    `padded_n` rows.  `values` replaces the layout's f32 values (the
    sweeps' bf16 mode passes its bf16 copy); products and sums are in x's
    dtype.  With `out` (..., padded_n) the product is added into it in
    place and `out` returned (the accumulating mode)."""
    _check_width(S, x)
    values = S.values if values is None else values
    prod = values.to(x.dtype) * x[..., S.columns.long()]
    y = torch.zeros(x.shape[:-1] + (S.n_slices * SLICE_ROWS,),
                    dtype=x.dtype, device=x.device)
    y.index_add_(y.ndim - 1, S.entry_rows(), prod)
    y = y[..., :S.padded_n]
    return y if out is None else out.add_(y)


def _check_width(S: SlicedELL, x: Tensor) -> None:
    if x.shape[-1] != S.x_len:
        width = (f"padded n {S.padded_n}" if S.n_cols is None
                 else f"{S.n_cols} columns")
        raise ValueError(f"signal length {x.shape[-1]} != the layout's "
                         f"{width}")


def _check_launch(S: SlicedELL, x: Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {x.device}")
    _check_width(S, x)
    if S.device != x.device:
        raise ValueError(f"layout on {S.device}, signals on {x.device}")
    if x.dtype != torch.float32 or S.values.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 values and signals")
    if S.columns.dtype != torch.int32 or S.offsets.dtype != torch.int32 \
            or S.widths.dtype != torch.int32:
        raise TypeError("sliced-ELL columns, offsets and widths are int32")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous signals")


def _lib() -> ctypes.CDLL:
    lib = _build.library("sliced_ell_spmv")
    fn = lib.sliced_ell_spmv_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_longlong] + [ctypes.c_int]
                       + [ctypes.c_void_p])
    fn = lib.sliced_ell_spmv_acc_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
    return lib


def _batch(x: Tensor) -> int:
    B = math.prod(x.shape[:-1])
    if B >= 2**31 // 16:
        raise ValueError(f"batch {B} too large for one launch")
    return B


def sliced_ell_spmv(S: SlicedELL, x: Tensor) -> Tensor:
    """Y = A @ X^T for square sliced-ELL A and signals x (..., padded_n).

    Returns (..., padded_n).  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/sliced_ell_spmv.cu`` (counted in
    ``sliced_ell_spmv.launches``).
    """
    if x.device.type == "cpu":
        return sliced_ell_spmv_plain(S, x)
    _check_launch(S, x, "sliced_ell_spmv")
    if S.n_cols is not None:
        raise ValueError("sliced_ell_spmv takes a square layout; a "
                         "rectangular one is applied by "
                         "sliced_ell_spmv_accumulate")
    y = torch.empty(x.shape[:-1] + (S.padded_n,), dtype=x.dtype,
                    device=x.device)
    B = _batch(x)
    if B == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sliced_ell_spmv_f32(
            S.values.data_ptr(), S.columns.data_ptr(), S.offsets.data_ptr(),
            S.widths.data_ptr(), x.data_ptr(), y.data_ptr(), S.n_slices,
            S.padded_n, B, stream)
    _build.check(lib, err, "sliced_ell_spmv")
    sliced_ell_spmv.launches += 1
    return y


sliced_ell_spmv.launches = 0


def sliced_ell_spmv_accumulate(C: SlicedELL, r: Tensor, y: Tensor) -> Tensor:
    """y += C @ r in place, for a sliced-ELL C of `C.padded_n` rows and
    `C.x_len` columns (square or rectangular): r (..., x_len), y (...,
    padded_n) with the same leading dims.  Returns y.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sliced_ell_spmv.cu`` in its rectangular, accumulating mode
    (counted in ``sliced_ell_spmv_accumulate.launches``).  Each row is
    summed by one thread in a fixed order: no atomics, the same bits on
    every call.
    """
    if r.device.type == "cpu":
        return sliced_ell_spmv_plain(C, r, out=y)
    _check_launch(C, r, "sliced_ell_spmv_accumulate")
    if (y.shape != r.shape[:-1] + (C.padded_n,) or y.device != r.device
            or y.dtype != torch.float32 or not y.is_contiguous()):
        raise ValueError(f"y {tuple(y.shape)} {y.dtype} on {y.device} does "
                         f"not take C r for r {tuple(r.shape)}: it must be a "
                         f"contiguous float32 (..., {C.padded_n}) beside r")
    B = _batch(r)
    if B == 0 or C.stored == 0:
        return y
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sliced_ell_spmv_acc_f32(
            C.values.data_ptr(), C.columns.data_ptr(), C.offsets.data_ptr(),
            C.widths.data_ptr(), r.data_ptr(), y.data_ptr(), C.n_slices,
            C.padded_n, C.x_len, B, stream)
    _build.check(lib, err, "sliced_ell_spmv_accumulate")
    sliced_ell_spmv_accumulate.launches += 1
    return y


sliced_ell_spmv_accumulate.launches = 0
