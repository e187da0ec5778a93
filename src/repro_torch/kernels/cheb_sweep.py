"""Whole-iteration sweeps for Hopper: all K orders of Algorithm 1, or all
rounds of a Section-V Jacobi solve, in ONE kernel launch.

``csrc/cheb_sweep.cu`` (replacing the JAX package's `cheb_sweep`) is a
cooperative kernel: a grid of co-resident thread blocks walks the 32-row
slices of P's sliced-ELL layout (`core.graph.SlicedELL`, a warp per
slice and tile of signals), computes each order's SpMV rows and the
fused three-term update of the same rows, with one grid-wide barrier
between orders, and forms the eta-fold accumulator once after the last
order.  Every iterate t_1..t_K is kept in device memory, signal-minor,
in the kernel's own (K, B, n) scratch; `ops.cheb_sweep_l2_bytes` models
whether the few each order re-reads stay in the L2.

``csrc/jacobi_sweep.cu`` (replacing the JAX package's `jacobi_sweep`) is
its Section-V counterpart: every round of Eq. (24) / (25) on den(P) x = b
— deg(den) sliced-ELL SpMVs by Horner plus the fused update — with one
grid-wide barrier per SpMV; `ops.jacobi_sweep_l2_bytes` is its footprint
model.

Both take ``scratch_dtype`` "f32" or "bf16", the JAX kernels' mixed
precision mode.  Under "bf16" the layout's values (its bf16 copy,
`SlicedELL.values_bf16`) and the iterates that the SpMV reads are bf16
(for `cheb_sweep` also x; for `jacobi_sweep` the Horner partial sums, and
x_prev as the update reads it), while the accumulator, the coefficient
and weight tables, and `jacobi_sweep`'s x, b, D^-1 and update stay f32.
Every SpMV sums in f32; each new bf16 value is computed in f32 and
rounded once where it is stored.

Dispatch: CPU tensors take the plain PyTorch versions (`cheb_sweep_plain`,
`jacobi_sweep_plain`, both modes); CUDA tensors launch the kernels or
raise.  A cooperative launch the card refuses raises; it never falls
back.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..core.graph import SlicedELL
from . import _build
from .bcsr_spmv import sliced_ell_spmv_plain

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


def _values(S: SlicedELL, scratch_dtype: str) -> Tensor:
    """The layout's values a sweep reads in `scratch_dtype`."""
    return S.values_bf16 if scratch_dtype == "bf16" else S.values


def _signal_tile(B: int, scratch_dtype: str) -> int:
    """Signals per tile of the sweeps: the batch rounded up to a power of
    two, at most 8 (one 32-byte sector per gather in f32, half of one in
    bf16, where 16 signals per tile took up to 1.3x longer on an H100:
    the registers they need left one thread block per SM); at least 2 in
    bf16 (a 4-byte word)."""
    tb = 2 if scratch_dtype == "bf16" else 1
    while tb < min(B, 8):
        tb *= 2
    return tb


def cheb_sweep_plain(S: SlicedELL, x: Tensor, coeffs: Tensor, *,
                     alpha: float, scratch_dtype: str = "f32") -> Tensor:
    """The whole K-order recurrence in plain PyTorch on the sliced-ELL
    SpMV's plain version.

    x: (..., padded_n) at the layout's padded size; coeffs: (eta, K+1).
    Returns (..., eta, padded_n).  Under ``scratch_dtype="bf16"`` the
    SpMV multiplies the layout's bf16 values, and x and every iterate are
    rounded to bf16 where the kernel stores them."""
    check_scratch_dtype(scratch_dtype)
    store = _store(scratch_dtype)
    values = _values(S, scratch_dtype)

    def spmv(t):
        return sliced_ell_spmv_plain(S, t, values=values)

    c = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    K = c.shape[1] - 1
    x = store(x)
    acc = 0.5 * c[:, 0:1] * x[..., None, :]
    if K == 0:
        return acc
    t0 = x
    t1 = store(spmv(x) / alpha - x)
    acc = acc + c[:, 1:2] * t1[..., None, :]
    for k in range(2, K + 1):
        tk = store((2.0 / alpha) * spmv(t1) - 2.0 * t1 - t0)
        acc = acc + c[:, k:k + 1] * tk[..., None, :]
        t0, t1 = t1, tk
    return acc


def _check_layout(S: SlicedELL, x: Tensor, what: str) -> None:
    """Raise on anything the sweep kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {x.device}")
    if S.device != x.device:
        raise ValueError(f"layout on {S.device}, signals on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 signals")
    if x.shape[-1] != S.padded_n:
        raise ValueError(f"signal length {x.shape[-1]} != the layout's "
                         f"padded n {S.padded_n}")


def _lib() -> ctypes.CDLL:
    lib = _build.library("cheb_sweep")
    for fn in (lib.cheb_sweep_f32, lib.cheb_sweep_bf16):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                           + [ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p])
    return lib


def cheb_sweep(S: SlicedELL, x: Tensor, coeffs, *, alpha: float,
               scratch_dtype: str = "f32") -> Tensor:
    """Full K-order shifted-Chebyshev recurrence in one kernel launch.

    S: P's sliced-ELL layout; x: (..., n) with n the layout's padded
    size; coeffs: (eta, K+1), K >= 1, host (copied to the card at each
    launch) or a float32 tensor on x's device (read in place: a plan
    keeps its tables there, so a captured launch copies nothing).
    Returns (..., eta, n).  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/cheb_sweep.cu`` (counted in ``cheb_sweep.launches``; the grid
    of the last launch is ``cheb_sweep.last_grid``).  scratch_dtype:
    "f32" or "bf16" (f32 x in, f32 out either way; see the module
    docstring).
    """
    sdt = check_scratch_dtype(scratch_dtype)
    if x.device.type == "cpu":
        return cheb_sweep_plain(S, x, coeffs, alpha=alpha,
                                scratch_dtype=scratch_dtype)
    _check_layout(S, x, "cheb_sweep")
    if not x.is_contiguous():
        raise ValueError("cheb_sweep takes contiguous signals")
    c = torch.as_tensor(coeffs, dtype=torch.float32, device=x.device)
    if c.ndim != 2 or c.shape[1] < 2:
        raise ValueError(f"coeffs must be (eta, K+1) with K >= 1, got "
                         f"{tuple(c.shape)}")
    eta, K1 = c.shape
    coefT = c.t().contiguous()                       # order-major (K+1, eta)
    n = S.padded_n
    lead = x.shape[:-1]
    B = math.prod(lead)
    acc = torch.empty(lead + (eta, n), dtype=x.dtype, device=x.device)
    if B == 0:
        return acc
    tb = _signal_tile(B, scratch_dtype)
    K = K1 - 1
    kept = torch.empty(K * -(-B // tb) * n * tb, dtype=sdt, device=x.device)
    grid = ctypes.c_int(0)
    lib = _lib()
    launch = lib.cheb_sweep_bf16 if scratch_dtype == "bf16" \
        else lib.cheb_sweep_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            _values(S, scratch_dtype).data_ptr(), S.columns.data_ptr(),
            S.offsets.data_ptr(), S.widths.data_ptr(), x.data_ptr(),
            coefT.data_ptr(), acc.data_ptr(), kept.data_ptr(), S.n_slices,
            n, B, tb, K, eta, float(alpha), stream, ctypes.addressof(grid))
    _build.check(lib, err, "cheb_sweep (cooperative launch)")
    cheb_sweep.launches += 1
    cheb_sweep.last_grid = grid.value
    return acc


cheb_sweep.launches = 0
cheb_sweep.last_grid = 0


def jacobi_sweep_plain(S: SlicedELL, b: Tensor, inv_d: Tensor, weights,
                       x0: Tensor, *, den,
                       scratch_dtype: str = "f32") -> Tensor:
    """The whole (accelerated-)Jacobi solve in plain PyTorch on the
    sliced-ELL SpMV's plain version, rounds unrolled like the JAX
    package's `ref.jacobi_sweep_ref`.

    b / x0: (..., n) at the layout's padded size; inv_d broadcastable;
    weights: (n_iters, 2) host (w_t, s_t); den: monomial coefficients,
    low degree first.  Returns x after n_iters rounds.  Under
    ``scratch_dtype="bf16"`` the SpMV multiplies the layout's bf16
    values, and every Horner partial sum and x_prev are rounded to bf16
    where the kernel stores (or reads) them."""
    check_scratch_dtype(scratch_dtype)
    store = _store(scratch_dtype)
    values = _values(S, scratch_dtype)
    ws = np.asarray(weights, dtype=np.float64)
    x, x_prev = x0, x0
    for t in range(ws.shape[0]):
        h = den[-1] * x
        for c in den[-2::-1]:
            h = store(sliced_ell_spmv_plain(S, h, values=values) + c * x)
        if len(den) == 1:
            h = store(h)
        x_next = float(ws[t, 0]) * (x + inv_d * (b - h)) \
            - float(ws[t, 1]) * store(x_prev)
        x, x_prev = x_next, x
    return torch.broadcast_to(x, torch.broadcast_shapes(b.shape, x0.shape))


def jacobi_table(den, weights, device) -> Tensor:
    """The f32 table one `jacobi_sweep` launch reads, on `device`: den's
    coefficients (low degree first), then the (w_t, s_t) rows of
    `weights`.  Built on the host and copied once; a caller that keeps it
    passes it as ``jacobi_sweep(..., table=)``."""
    ws = np.asarray(weights, dtype=np.float64)
    return torch.tensor([float(c) for c in den] + ws.reshape(-1).tolist(),
                        dtype=torch.float32).to(device)


def _jacobi_lib() -> ctypes.CDLL:
    lib = _build.library("jacobi_sweep")
    for fn in (lib.jacobi_sweep_f32, lib.jacobi_sweep_bf16):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                           + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                           + [ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_void_p])
    return lib


def jacobi_sweep(S: SlicedELL, b: Tensor, inv_d: Tensor, weights,
                 x0: Tensor, *, den, scratch_dtype: str = "f32",
                 table: Optional[Tensor] = None) -> Tensor:
    """Whole (accelerated-)Jacobi solve of den(P) x = b in one launch.

    S: P's sliced-ELL layout; b / x0: (..., n) at the layout's padded
    size; inv_d: a shared (n,) row or broadcastable to b (zeros on padded
    rows keep those rows zero).  weights: (n_iters, 2) host (w_t, s_t)
    schedule, cast to f32 on the device; den: monomial coefficients of
    the split polynomial, low degree first, any degree (the CUDA kernel
    loops at run time, so there is no unroll budget).  Returns x after
    n_iters rounds, shape broadcast(b, x0).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/jacobi_sweep.cu`` (counted in
    ``jacobi_sweep.launches``; the grid of the last launch is
    ``jacobi_sweep.last_grid``).  scratch_dtype: "f32" or "bf16" (f32
    operands in, f32 x out either way; see the module docstring).
    table: :func:`jacobi_table` of (den, weights) already on b's device,
    read in place; None builds it (a host-to-device copy per launch).
    """
    sdt = check_scratch_dtype(scratch_dtype)
    den = tuple(float(c) for c in den)
    if not den:
        raise ValueError("den must have at least one coefficient")
    ws = np.asarray(weights, dtype=np.float64)
    if ws.ndim != 2 or ws.shape[1] != 2:
        raise ValueError(f"weights must be (n_iters, 2), got {ws.shape}")
    if b.device.type == "cpu":
        return jacobi_sweep_plain(S, b, inv_d, ws, x0, den=den,
                                  scratch_dtype=scratch_dtype)
    _check_layout(S, b, "jacobi_sweep")
    n = S.padded_n
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
    if table is None:
        table = jacobi_table(den, ws, b.device)
    elif (table.device != b.device or table.dtype != torch.float32
          or table.shape != (len(den) + 2 * n_iters,)):
        raise ValueError(f"table {tuple(table.shape)} {table.dtype} on "
                         f"{table.device} is not jacobi_table(den, weights) "
                         f"on {b.device}")
    tb = _signal_tile(B, scratch_dtype)
    size = -(-B // tb) * n * tb
    U, V = (torch.empty(size, dtype=b.dtype, device=b.device)
            for _ in range(2))
    H0, H1 = (torch.empty(size, dtype=sdt, device=b.device)
              for _ in range(2))
    out = torch.empty((B, n), dtype=b.dtype, device=b.device)
    grid = ctypes.c_int(0)
    lib = _jacobi_lib()
    launch = lib.jacobi_sweep_bf16 if scratch_dtype == "bf16" \
        else lib.jacobi_sweep_f32
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            _values(S, scratch_dtype).data_ptr(), S.columns.data_ptr(),
            S.offsets.data_ptr(), S.widths.data_ptr(), b2.data_ptr(),
            d2.data_ptr(), d_stride, x02.data_ptr(), table.data_ptr(),
            U.data_ptr(), V.data_ptr(), H0.data_ptr(), H1.data_ptr(),
            out.data_ptr(), S.n_slices, n, B, tb, n_iters, len(den) - 1,
            stream, ctypes.addressof(grid))
    _build.check(lib, err, "jacobi_sweep (cooperative launch)")
    jacobi_sweep.launches += 1
    jacobi_sweep.last_grid = grid.value
    return out.reshape(full)


jacobi_sweep.launches = 0
jacobi_sweep.last_grid = 0
