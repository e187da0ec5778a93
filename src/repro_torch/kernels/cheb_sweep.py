"""Whole-recurrence Chebyshev sweep for Hopper: all K orders of Algorithm 1
in ONE kernel launch.

``csrc/cheb_sweep.cu`` (replacing the JAX package's `cheb_sweep`) is a
cooperative kernel: a grid of co-resident thread blocks walks the
Block-ELL row blocks, computes each order's SpMV rows and applies the
fused three-term update and eta-fold accumulation to the same rows, with
one grid-wide barrier between orders.  The iterates live in device
memory; `ops.cheb_sweep_l2_bytes` models whether they stay in the L2.

Dispatch: CPU tensors take the plain PyTorch version (`cheb_sweep_plain`);
CUDA tensors launch the kernel or raise.  A cooperative launch the card
refuses raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .bcsr_spmv import block_ell_spmv_plain, check_block_ell

Tensor = torch.Tensor

#: Where the reduced-precision sweep mode stands in ROADMAP.md.
BF16_ROADMAP = ("the bf16 sweep_dtype mode is not ported yet "
                "(ROADMAP.md, queue 2: cheb_sweep scratch_dtype='bf16')")


def cheb_sweep_plain(blocks: Tensor, indices: Tensor, x: Tensor,
                     coeffs: Tensor, *, alpha: float) -> Tensor:
    """The whole K-order recurrence in plain PyTorch.

    x: (..., n) at the Block-ELL padded size; coeffs: (eta, K+1).
    Returns (..., eta, n)."""
    c = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    K = c.shape[1] - 1
    acc = 0.5 * c[:, 0:1] * x[..., None, :]
    if K == 0:
        return acc
    t0 = x
    t1 = block_ell_spmv_plain(blocks, indices, x) / alpha - x
    acc = acc + c[:, 1:2] * t1[..., None, :]
    for k in range(2, K + 1):
        pt = block_ell_spmv_plain(blocks, indices, t1)
        tk = (2.0 / alpha) * pt - 2.0 * t1 - t0
        acc = acc + c[:, k:k + 1] * tk[..., None, :]
        t0, t1 = t1, tk
    return acc


def _lib() -> ctypes.CDLL:
    lib = _build.library("cheb_sweep")
    fn = lib.cheb_sweep_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    return lib


def cheb_sweep(blocks: Tensor, indices: Tensor, x: Tensor, coeffs,
               *, alpha: float, scratch_dtype: str = "f32") -> Tensor:
    """Full K-order shifted-Chebyshev recurrence in one kernel launch.

    blocks/indices: Block-ELL structure; x: (..., n) with n the padded
    size (n = nrb * br); coeffs: (eta, K+1), K >= 1.  Returns
    (..., eta, n).  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/cheb_sweep.cu`` (counted in ``cheb_sweep.launches``;
    the grid of the last launch is ``cheb_sweep.last_grid``).
    """
    if scratch_dtype == "bf16":
        raise NotImplementedError(BF16_ROADMAP)
    if scratch_dtype != "f32":
        raise ValueError(f"scratch_dtype must be 'f32', got {scratch_dtype!r}")
    if x.device.type == "cpu":
        return cheb_sweep_plain(blocks, indices, x, coeffs, alpha=alpha)
    check_block_ell(blocks, indices, x)
    nrb, slots, br, bc = blocks.shape
    n = x.shape[-1]
    if n != nrb * br:
        raise ValueError(f"x length {n} != Block-ELL padded size {nrb * br}")
    c = torch.as_tensor(coeffs, dtype=torch.float32, device=x.device)
    if c.ndim != 2 or c.shape[1] < 2:
        raise ValueError(f"coeffs must be (eta, K+1) with K >= 1, got "
                         f"{tuple(c.shape)}")
    eta, K1 = c.shape
    coefT = c.t().contiguous()                       # order-major (K+1, eta)
    lead = x.shape[:-1]
    B = math.prod(lead)
    acc = torch.empty(lead + (eta, n), dtype=x.dtype, device=x.device)
    if B == 0:
        return acc
    U = torch.empty((B, n), dtype=x.dtype, device=x.device)
    V = torch.empty((B, n), dtype=x.dtype, device=x.device)
    grid = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cheb_sweep_f32(
            blocks.data_ptr(), indices.data_ptr(), x.data_ptr(),
            coefT.data_ptr(), acc.data_ptr(), U.data_ptr(), V.data_ptr(),
            nrb, slots, br, bc, B, K1 - 1, eta, float(alpha), stream,
            ctypes.addressof(grid))
    _build.check(lib, err, "cheb_sweep (cooperative launch)")
    cheb_sweep.launches += 1
    cheb_sweep.last_grid = grid.value
    return acc


cheb_sweep.launches = 0
cheb_sweep.last_grid = 0
