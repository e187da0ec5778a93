"""Whole-iteration sweeps for Hopper: all K orders of Algorithm 1, or all
rounds of a Section-V Jacobi solve, in ONE kernel launch.

``csrc/cheb_sweep.cu`` (replacing the JAX package's `cheb_sweep`) is a
cooperative kernel: a grid of co-resident thread blocks walks the
Block-ELL row blocks, computes each order's SpMV rows and applies the
fused three-term update and eta-fold accumulation to the same rows, with
one grid-wide barrier between orders.  The iterates live in device
memory; `ops.cheb_sweep_l2_bytes` models whether they stay in the L2.

``csrc/jacobi_sweep.cu`` (replacing the JAX package's `jacobi_sweep`) is
its Section-V counterpart: every round of Eq. (24) / (25) on den(P) x = b
— deg(den) Block-ELL SpMVs by Horner plus the fused update — with one
grid-wide barrier per SpMV; `ops.jacobi_sweep_l2_bytes` is its footprint
model.

Both take ``scratch_dtype`` "f32" or "bf16", the JAX kernels' mixed
precision mode.  Under "bf16" the Block-ELL blocks and the iterates that
the SpMV reads are bf16 (for `cheb_sweep` also x; for `jacobi_sweep` the
Horner partial sums, and x_prev as the update reads it), while the
accumulator, the coefficient and weight tables, and `jacobi_sweep`'s x, b,
D^-1 and update stay f32.  Every SpMV sums in f32; each new bf16 value is
computed in f32 and rounded once where it is stored.  The f32 blocks are
cast to bf16 per launch (one pass over them, small beside the sweep).

Dispatch: CPU tensors take the plain PyTorch versions (`cheb_sweep_plain`,
`jacobi_sweep_plain`, both modes); CUDA tensors launch the kernels or
raise.  A cooperative launch the card refuses raises; it never falls
back.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .bcsr_spmv import block_ell_spmv_plain, check_block_ell

Tensor = torch.Tensor

#: The sweeps' scratch dtypes (the JAX package's `SCRATCH_DTYPES`).
SCRATCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def check_scratch_dtype(scratch_dtype) -> torch.dtype:
    """The torch dtype of a scratch mode; anything else raises ValueError."""
    try:
        return SCRATCH_DTYPES[scratch_dtype]
    except (KeyError, TypeError):
        raise ValueError(f"scratch_dtype must be one of "
                         f"{tuple(SCRATCH_DTYPES)}, got {scratch_dtype!r}"
                         ) from None


def _store(scratch_dtype: str):
    """What storing an f32 value in the scratch dtype does to it."""
    if scratch_dtype == "f32":
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(t.dtype)


def cheb_sweep_plain(blocks: Tensor, indices: Tensor, x: Tensor,
                     coeffs: Tensor, *, alpha: float,
                     scratch_dtype: str = "f32") -> Tensor:
    """The whole K-order recurrence in plain PyTorch.

    x: (..., n) at the Block-ELL padded size; coeffs: (eta, K+1).
    Returns (..., eta, n).  Under ``scratch_dtype="bf16"`` x, the blocks
    and every iterate are rounded to bf16 where the kernel stores them."""
    check_scratch_dtype(scratch_dtype)
    store = _store(scratch_dtype)
    blocks = store(blocks)
    c = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    K = c.shape[1] - 1
    x = store(x)
    acc = 0.5 * c[:, 0:1] * x[..., None, :]
    if K == 0:
        return acc
    t0 = x
    t1 = store(block_ell_spmv_plain(blocks, indices, x) / alpha - x)
    acc = acc + c[:, 1:2] * t1[..., None, :]
    for k in range(2, K + 1):
        pt = block_ell_spmv_plain(blocks, indices, t1)
        tk = store((2.0 / alpha) * pt - 2.0 * t1 - t0)
        acc = acc + c[:, k:k + 1] * tk[..., None, :]
        t0, t1 = t1, tk
    return acc


def _lib() -> ctypes.CDLL:
    lib = _build.library("cheb_sweep")
    for fn in (lib.cheb_sweep_f32, lib.cheb_sweep_bf16):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p])
    return lib


def cheb_sweep(blocks: Tensor, indices: Tensor, x: Tensor, coeffs,
               *, alpha: float, scratch_dtype: str = "f32") -> Tensor:
    """Full K-order shifted-Chebyshev recurrence in one kernel launch.

    blocks/indices: Block-ELL structure; x: (..., n) with n the padded
    size (n = nrb * br); coeffs: (eta, K+1), K >= 1.  Returns
    (..., eta, n).  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/cheb_sweep.cu`` (counted in ``cheb_sweep.launches``;
    the grid of the last launch is ``cheb_sweep.last_grid``).
    scratch_dtype: "f32" or "bf16" (f32 x and blocks in, f32 out either
    way; see the module docstring).
    """
    sdt = check_scratch_dtype(scratch_dtype)
    if x.device.type == "cpu":
        return cheb_sweep_plain(blocks, indices, x, coeffs, alpha=alpha,
                                scratch_dtype=scratch_dtype)
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
    blocks_s = blocks.to(sdt)
    x_s = x.to(sdt)
    U = torch.empty((B, n), dtype=sdt, device=x.device)
    V = torch.empty((B, n), dtype=sdt, device=x.device)
    grid = ctypes.c_int(0)
    lib = _lib()
    launch = lib.cheb_sweep_bf16 if scratch_dtype == "bf16" \
        else lib.cheb_sweep_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            blocks_s.data_ptr(), indices.data_ptr(), x_s.data_ptr(),
            coefT.data_ptr(), acc.data_ptr(), U.data_ptr(), V.data_ptr(),
            nrb, slots, br, bc, B, K1 - 1, eta, float(alpha), stream,
            ctypes.addressof(grid))
    _build.check(lib, err, "cheb_sweep (cooperative launch)")
    cheb_sweep.launches += 1
    cheb_sweep.last_grid = grid.value
    return acc


cheb_sweep.launches = 0
cheb_sweep.last_grid = 0


def jacobi_sweep_plain(blocks: Tensor, indices: Tensor, b: Tensor,
                       inv_d: Tensor, weights, x0: Tensor, *,
                       den, scratch_dtype: str = "f32") -> Tensor:
    """The whole (accelerated-)Jacobi solve in plain PyTorch, rounds
    unrolled like the JAX package's `ref.jacobi_sweep_ref`.

    b / x0: (..., n) at the Block-ELL padded size; inv_d broadcastable;
    weights: (n_iters, 2) host (w_t, s_t); den: monomial coefficients,
    low degree first.  Returns x after n_iters rounds.  Under
    ``scratch_dtype="bf16"`` the blocks, every Horner partial sum after
    the first SpMV and x_prev are rounded to bf16 where the kernel stores
    (or reads) them."""
    check_scratch_dtype(scratch_dtype)
    store = _store(scratch_dtype)
    blocks = store(blocks)
    ws = np.asarray(weights, dtype=np.float64)
    x, x_prev = x0, x0
    for t in range(ws.shape[0]):
        h = den[-1] * x
        for c in den[-2::-1]:
            h = store(block_ell_spmv_plain(blocks, indices, h) + c * x)
        if len(den) == 1:
            h = store(h)
        x_next = float(ws[t, 0]) * (x + inv_d * (b - h)) \
            - float(ws[t, 1]) * store(x_prev)
        x, x_prev = x_next, x
    return torch.broadcast_to(x, torch.broadcast_shapes(b.shape, x0.shape))


def _jacobi_lib() -> ctypes.CDLL:
    lib = _build.library("jacobi_sweep")
    for fn in (lib.jacobi_sweep_f32, lib.jacobi_sweep_bf16):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                           + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p, ctypes.c_void_p])
    return lib


def jacobi_sweep(blocks: Tensor, indices: Tensor, b: Tensor, inv_d: Tensor,
                 weights, x0: Tensor, *, den,
                 scratch_dtype: str = "f32") -> Tensor:
    """Whole (accelerated-)Jacobi solve of den(P) x = b in one launch.

    b / x0: (..., n) at the Block-ELL padded size; inv_d: a shared (n,)
    row or broadcastable to b (zeros on padded rows keep those rows
    zero).  weights: (n_iters, 2) host (w_t, s_t) schedule, cast to f32 on
    the device; den: monomial coefficients of the split polynomial, low
    degree first, any degree (the CUDA kernel loops at run time, so there
    is no unroll budget).  Returns x after n_iters rounds, shape
    broadcast(b, x0).  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/jacobi_sweep.cu`` (counted in ``jacobi_sweep.launches``;
    the grid of the last launch is ``jacobi_sweep.last_grid``).
    scratch_dtype: "f32" or "bf16" (f32 operands in, f32 x out either way;
    see the module docstring).
    """
    sdt = check_scratch_dtype(scratch_dtype)
    den = tuple(float(c) for c in den)
    if not den:
        raise ValueError("den must have at least one coefficient")
    ws = np.asarray(weights, dtype=np.float64)
    if ws.ndim != 2 or ws.shape[1] != 2:
        raise ValueError(f"weights must be (n_iters, 2), got {ws.shape}")
    if b.device.type == "cpu":
        return jacobi_sweep_plain(blocks, indices, b, inv_d, ws, x0, den=den,
                                  scratch_dtype=scratch_dtype)
    check_block_ell(blocks, indices, b)
    nrb, slots, br, bc = blocks.shape
    n = b.shape[-1]
    if n != nrb * br:
        raise ValueError(f"b length {n} != Block-ELL padded size {nrb * br}")
    if any(t.device != b.device for t in (inv_d, x0)):
        raise ValueError("jacobi_sweep operands must share one device")
    if any(t.dtype != torch.float32 for t in (inv_d, x0)):
        raise TypeError("jacobi_sweep takes float32 operands")
    full = torch.broadcast_shapes(b.shape, x0.shape)
    B = math.prod(full[:-1])
    b2 = b.expand(full).reshape(B, n).contiguous()
    x02 = x0.expand(full).reshape(B, n).contiguous()
    if inv_d.numel() == n:
        d2, d_stride = inv_d.reshape(n).contiguous(), 0
    else:
        d2, d_stride = inv_d.expand(full).reshape(B, n).contiguous(), n
    n_iters = ws.shape[0]
    if B == 0 or n_iters == 0:
        return x02.clone().reshape(full)
    table = torch.tensor(list(den) + ws.reshape(-1).tolist(),
                         dtype=torch.float32).to(b.device)
    U, V = (torch.empty((B, n), dtype=b.dtype, device=b.device)
            for _ in range(2))
    H0, H1 = (torch.empty((B, n), dtype=sdt, device=b.device)
              for _ in range(2))
    blocks_s = blocks.to(sdt)
    grid = ctypes.c_int(0)
    lib = _jacobi_lib()
    launch = lib.jacobi_sweep_bf16 if scratch_dtype == "bf16" \
        else lib.jacobi_sweep_f32
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            blocks_s.data_ptr(), indices.data_ptr(), b2.data_ptr(),
            d2.data_ptr(), d_stride, x02.data_ptr(), table.data_ptr(),
            U.data_ptr(), V.data_ptr(), H0.data_ptr(), H1.data_ptr(),
            nrb, slots, br, bc, B, n_iters, len(den) - 1, stream,
            ctypes.addressof(grid))
    _build.check(lib, err, "jacobi_sweep (cooperative launch)")
    jacobi_sweep.launches += 1
    jacobi_sweep.last_grid = grid.value
    return (U if n_iters % 2 else V).reshape(full)


jacobi_sweep.launches = 0
jacobi_sweep.last_grid = 0
