"""Dispatch between the Hopper kernels and the per-order recurrence.

Everything above this module — the `cuda` execution backend, the solvers,
the lasso, the tests, ``chip_smoke.py`` — calls these functions; the
kernel wrappers (`bcsr_spmv.sliced_ell_spmv`, `cheb_step.cheb_step`,
`cheb_sweep.cheb_sweep`, `cheb_sweep.jacobi_sweep`,
`jacobi_step.jacobi_step`, `soft_threshold.ista_shrink`,
`flash_attention.flash_attention`) pick the CUDA kernel for a CUDA tensor
and their plain PyTorch version for a CPU tensor.

Every SpMV this module serves (:func:`spmv`: the plan's matvec for the
adjoint, the Gram's and ARMA's runners and the lasso, the per-order and
per-round paths) and both sweeps read the sliced-ELL layout that the
Block-ELL matrix carries (`BlockELL.sliced_ell`, packed on its device
once); no kernel reads the Block-ELL blocks.

Single-launch sweep dispatch: a matvec tagged with ``mv.block_ell = A``
(a local Block-ELL product) routes the whole K-order loop of
:func:`fused_cheb_recurrence` to :func:`fused_cheb_sweep`: one
cooperative kernel launch for all orders.  The upgrade is guarded by the
L2 footprint model :func:`cheb_sweep_l2_bytes`; a problem over the budget
takes the per-order path (one SpMV launch and one `cheb_step` launch per
order), logged at INFO.  `plan.solve`'s Jacobi methods take the same
route to :func:`fused_jacobi_sweep` (one `jacobi_sweep` launch per solve,
guarded by :func:`jacobi_sweep_l2_bytes`, with a logged per-round
fallback).  Both sweeps take the JAX package's ``scratch_dtype="bf16"``
mode (a matvec tagged ``mv.sweep_dtype = "bf16"``); the guards count its
bf16 buffers at 2 bytes, and over budget the fallback is the f32
per-order (per-round) path, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..core.chebyshev import _coeff_tensor, _stateful_matvec
from ..core.graph import BlockELL
from .bcsr_spmv import sliced_ell_spmv
from .cheb_step import cheb_step
from .cheb_sweep import check_scratch_dtype, cheb_sweep, jacobi_sweep
# the LM's attn_impl="flash" (models.layers.attention) calls it from here
from .flash_attention import flash_attention  # noqa: F401
from .jacobi_step import jacobi_step
from .soft_threshold import ista_shrink

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

#: The H100's L2 cache: 50 MiB.  The sweep's reused working set is held
#: against it (see :func:`cheb_sweep_l2_bytes`).
DEFAULT_SWEEP_L2_BUDGET = 50 * 1024 * 1024


def spmv(A: BlockELL, x: Tensor) -> Tensor:
    """y = A @ x on padded signals (..., padded_n), through A's sliced-ELL
    layout (packed from the blocks at the first call, then kept on A).

    One call per Chebyshev order; leading batch dims (batch signals, eta
    streams) ride one pass over the sparsity structure.
    """
    return sliced_ell_spmv(A.sliced_ell(), x)


def _scratch_itemsize(scratch_dtype: Optional[str], itemsize: int) -> int:
    """Bytes per element of a sweep's scratch buffers: 2 under the bf16
    mode, the wide `itemsize` otherwise (the JAX package's
    `_scratch_itemsize`)."""
    check_scratch_dtype(scratch_dtype or "f32")
    return 2 if scratch_dtype == "bf16" else itemsize


def _structure_bytes(stored: int, scratch_dtype: Optional[str]) -> int:
    """Bytes of a sliced-ELL layout a sweep reads: a value (4 B, or its
    bf16 copy's 2 B) and an int32 column per stored entry."""
    return stored * (4 + _scratch_itemsize(scratch_dtype, 4))


def cheb_sweep_l2_bytes(n: int, batch: int = 1, itemsize: int = 4,
                        scratch_dtype: Optional[str] = None,
                        stored: int = 0) -> int:
    """L2 footprint model for one `cheb_sweep` launch on Hopper.

    The sweep keeps nothing on chip across its grid barriers: the iterates
    live in device memory.  What each order re-reads of the orders before
    is the reused working set — the three (B, n) iterates t_{k-1} (read by
    the SpMV of every slice that couples to it), t_{k-2} and the new t_k,
    and the `stored` entries of the sliced-ELL layout that every order's
    SpMV reads again:

        3 * B * n * s + stored * (4 + s') bytes,

    with s the scratch width (2 under ``scratch_dtype="bf16"``, else
    `itemsize`) and s' the width of the values the sweep reads (4, or 2
    for the layout's bf16 copy) beside each 4-byte column.  The kernel
    keeps every t_k in its own buffer and forms the (B, eta, n)
    accumulator once, after the last order, so the older iterates (read
    once, at the end) and the accumulator (written once) stream through
    the L2 and are not counted.  When the working set fits in the 50 MiB
    L2 (:data:`DEFAULT_SWEEP_L2_BUDGET`), orders after the first find it
    on chip.
    """
    sb = _scratch_itemsize(scratch_dtype, itemsize)
    return 3 * batch * n * sb + _structure_bytes(stored, scratch_dtype)


def _per_order_cheb(A: BlockELL, x: Tensor, coeffs, lmax: float) -> Tensor:
    """Per-order path: one SpMV + one `cheb_step` launch per order."""
    return _cheb_recurrence_loop(lambda t: spmv(A, t), x, coeffs, lmax)


def fused_cheb_sweep(
    A: BlockELL,
    x: Tensor,
    coeffs,
    lmax: float,
    l2_budget: Optional[int] = None,
    scratch_dtype: Optional[str] = None,
) -> Tensor:
    """Phi_tilde x with the single-launch sweep.

    x: (..., padded_n) at A's Block-ELL padded size; coeffs: (eta, K+1)
    (or (K+1,)), host or a tensor on x's device (used without a copy).
    Returns (..., eta, padded_n).  The whole K-order
    recurrence is ONE `cheb_sweep` launch on A's sliced-ELL layout,
    guarded by :func:`cheb_sweep_l2_bytes` against `l2_budget` (default
    :data:`DEFAULT_SWEEP_L2_BUDGET`): a working set over the budget takes
    the per-order path, logged at INFO.  K < 2 takes the per-order path
    too (there is no recurrence to fuse).  scratch_dtype: None / "f32" or
    "bf16", the sweep's mixed-precision mode; the guard counts its bf16
    buffers at 2 bytes, and the per-order fallback is f32.
    """
    sdt = scratch_dtype or "f32"
    check_scratch_dtype(sdt)
    c = (torch.atleast_2d(coeffs) if isinstance(coeffs, Tensor)
         else np.atleast_2d(np.asarray(coeffs)))
    eta, K1 = c.shape
    K = K1 - 1
    if K < 2:
        return _per_order_cheb(A, x, c, lmax)
    budget = DEFAULT_SWEEP_L2_BUDGET if l2_budget is None else int(l2_budget)
    S = A.sliced_ell()
    n = x.shape[-1]
    batch = max(1, x.numel() // n)
    need = cheb_sweep_l2_bytes(n, batch, x.element_size(),
                               scratch_dtype=sdt, stored=S.stored)
    if need > budget:
        logger.info(
            "cheb_sweep: L2 working set %d B exceeds budget %d B "
            "(n=%d, eta=%d, K=%d, B=%d) — falling back to the per-order "
            "cheb_step path", need, budget, n, eta, K, batch)
        return _per_order_cheb(A, x, c, lmax)
    return cheb_sweep(S, x.contiguous(), c, alpha=float(lmax) / 2.0,
                      scratch_dtype=sdt)


def fused_cheb_recurrence(matvec, x: Tensor, coeffs, lmax: float) -> Tensor:
    """Fused shifted-Chebyshev recurrence over an arbitrary matvec.

    A matvec tagged with ``mv.block_ell = A`` (a purely local Block-ELL
    product) routes the whole loop to :func:`fused_cheb_sweep`, padding x
    to A's size and cropping the result; an optional ``mv.l2_budget``
    overrides the sweep budget and an optional ``mv.sweep_dtype``
    ("bf16") selects the sweep's mixed-precision mode.  Any other matvec
    runs the per-order loop.

    x: (..., n); coeffs: (eta, K+1) (or (K+1,), treated as eta=1).
    Returns (..., eta, n).
    """
    A_local = getattr(matvec, "block_ell", None)
    if A_local is not None:
        n_logical = x.shape[-1]
        out = fused_cheb_sweep(
            A_local, pad_trailing(x, A_local.padded_n), coeffs, lmax,
            l2_budget=getattr(matvec, "l2_budget", None),
            scratch_dtype=getattr(matvec, "sweep_dtype", None))
        return out[..., :n_logical]
    return _cheb_recurrence_loop(matvec, x, coeffs, lmax)


def _cheb_recurrence_loop(matvec, x: Tensor, coeffs, lmax: float) -> Tensor:
    """The per-order recurrence loop (one matvec + one fused step per
    order), with the stateful-matvec protocol of
    `core.chebyshev._stateful_matvec`."""
    c = torch.atleast_2d(_coeff_tensor(coeffs, x))
    K = c.shape[1] - 1
    alpha = float(lmax) / 2.0

    acc = 0.5 * c[:, 0:1] * x[..., None, :]
    if K == 0:
        return acc
    mv2, st = _stateful_matvec(matvec, x)
    px, st = mv2(x, st)
    t1 = px / alpha - x
    acc = acc + c[:, 1:2] * t1[..., None, :]
    t_km1, t_km2 = t1, x.contiguous()
    cT = c.T.contiguous()                       # order-major rows c_k
    for k in range(2, K + 1):
        pt, st = mv2(t_km1, st)
        t_k, acc = cheb_step(pt.contiguous(), t_km1, t_km2, acc, cT[k],
                             alpha=alpha)
        t_km1, t_km2 = t_k, t_km1
    return acc


def fused_cheb_apply(
    A: BlockELL,
    x: Tensor,
    coeffs,
    lmax: float,
    *,
    sweep: Optional[bool] = None,
    l2_budget: Optional[int] = None,
    scratch_dtype: Optional[str] = None,
) -> Tensor:
    """Phi_tilde x with the Hopper kernels (Algorithm 1).

    x: (..., padded_n), last axis at A's Block-ELL padded size; leading
    batch dims share the K structure sweeps.  Returns
    (..., eta, padded_n).

    sweep: None (default) routes through the single-launch
    :func:`fused_cheb_sweep` (which guards on the L2 budget and falls
    back to the per-order path); False forces the per-order SpMV +
    `cheb_step` loop.  scratch_dtype: the sweep's mixed-precision mode
    ("bf16"), ignored on the per-order path.
    """
    if sweep is None or sweep:
        return fused_cheb_sweep(A, x, coeffs, lmax, l2_budget=l2_budget,
                                scratch_dtype=scratch_dtype)
    return _per_order_cheb(A, x, coeffs, lmax)


def jacobi_update(qx: Tensor, x: Tensor, x_prev: Tensor, y: Tensor,
                  inv_d: Tensor, *, w, s) -> Tensor:
    """One fused (accelerated-)Jacobi round after the matvec ``qx = Q @ x``:

        x_next = w * (x + inv_d * (y - qx)) - s * x_prev

    (w = 1, s = 0 is the plain Jacobi round of Eq. (24); the Eq. (25)
    weights vary per round).  A CUDA tensor launches the `jacobi_step`
    kernel, a CPU tensor takes its plain version.  y / inv_d may be
    shared (n,) rows.
    """
    return jacobi_step(qx, x, x_prev, y, inv_d, w=w, s=s)


def jacobi_sweep_l2_bytes(n: int, batch: int = 1, itemsize: int = 4,
                          scratch_dtype: Optional[str] = None,
                          stored: int = 0) -> int:
    """L2 footprint model for one `jacobi_sweep` launch on Hopper.

    The counterpart of the JAX package's `jacobi_sweep_vmem_bytes`: what
    every round re-reads are six (B, n) buffers — the iterate x, x_prev,
    the two Horner buffers (h and the SpMV product q), the right-hand
    side b and D^{-1}:

        (4 * itemsize + 2 * s) * B * n + stored * (4 + s') bytes,

    with s the scratch width of the two Horner buffers (2 under
    ``scratch_dtype="bf16"``, else `itemsize`).  x_prev counts at the
    wide `itemsize` in both modes: the kernel keeps it in the f32 buffer
    of the previous x and rounds it to bf16 as it reads it, where the JAX
    kernel held a bf16 copy (its model has 3 * s + 3 * itemsize).  The
    `stored` entries of the sliced-ELL layout, which every SpMV reads
    again, count as in :func:`cheb_sweep_l2_bytes`.
    """
    sb = _scratch_itemsize(scratch_dtype, itemsize)
    return ((4 * itemsize + 2 * sb) * batch * n
            + _structure_bytes(stored, scratch_dtype))


def _per_round_jacobi(A: BlockELL, b: Tensor, inv_d: Tensor, den, ws,
                      x0: Tensor) -> Tensor:
    """Per-round path: deg(den) SpMV launches (Horner) and one
    `jacobi_step` launch per round."""
    x, x_prev = x0, x0
    for w, s in ws:
        h = den[-1] * x
        for c in den[-2::-1]:
            h = spmv(A, h.contiguous()) + c * x
        x, x_prev = jacobi_update(h, x, x_prev, b, inv_d, w=float(w),
                                  s=float(s)), x
    return x


def fused_jacobi_sweep(
    A: BlockELL,
    b: Tensor,
    inv_d: Tensor,
    den,
    weights,
    *,
    x0: Optional[Tensor] = None,
    l2_budget: Optional[int] = None,
    scratch_dtype: Optional[str] = None,
    table: Optional[Tensor] = None,
) -> Tensor:
    """Whole (accelerated-)Jacobi solve of den(P) x = b, one launch.

    The Section-V counterpart of :func:`fused_cheb_sweep`: all n_iters
    rounds of Eq. (24)/(25) — deg(den) SpMVs per round (Horner) on A's
    sliced-ELL layout plus the fused update — run inside one
    `jacobi_sweep` launch.  b / x0: (..., n) at any n (padded to A's
    Block-ELL size here, cropped on return); inv_d broadcastable, zeros
    on padded rows.  weights:
    (n_iters, 2) host (w_t, s_t) schedule (`core.jacobi.jacobi_weights` /
    `cheb_jacobi_weights`).  Guarded by :func:`jacobi_sweep_l2_bytes`
    against `l2_budget` (default :data:`DEFAULT_SWEEP_L2_BUDGET`): a
    working set over the budget takes the per-round path (SpMV and
    `jacobi_step` launches, f32), logged at INFO.  scratch_dtype: None /
    "f32" or "bf16", the sweep's mixed-precision mode.  table: the
    launch's `cheb_sweep.jacobi_table` of (den, weights), already on b's
    device (the solvers keep one per operator); None builds it here.
    """
    sdt = scratch_dtype or "f32"
    check_scratch_dtype(sdt)
    n_logical = b.shape[-1]
    total = A.padded_n
    bp = pad_trailing(b, total)
    invdp = pad_trailing(inv_d, total)
    x0p = torch.zeros_like(bp) if x0 is None else pad_trailing(x0, total)
    den = tuple(float(c) for c in den)
    ws = np.asarray(weights, dtype=np.float64)
    budget = DEFAULT_SWEEP_L2_BUDGET if l2_budget is None else int(l2_budget)
    S = A.sliced_ell()
    batch = max(1, torch.broadcast_shapes(bp.shape, x0p.shape)[:-1].numel())
    need = jacobi_sweep_l2_bytes(total, batch, bp.element_size(),
                                 scratch_dtype=sdt, stored=S.stored)
    if need > budget:
        logger.info(
            "jacobi_sweep: L2 working set %d B exceeds budget %d B "
            "(n=%d, B=%d) — falling back to the per-round jacobi_step "
            "path", need, budget, total, batch)
        out = _per_round_jacobi(A, bp, invdp, den, ws, x0p)
    else:
        out = jacobi_sweep(S, bp, invdp, ws, x0p, den=den,
                           scratch_dtype=sdt, table=table)
    return out[..., :n_logical]


def ista_update(a: Tensor, phi_y: Tensor, gram_a: Tensor, thresh,
                gamma: float) -> Tensor:
    """One fused ISTA update (Algorithm 3 line 5 + the Eq. (32)
    shrinkage): ``soft_threshold(a + gamma * (phi_y - gram_a), thresh)``
    in a single pass.  a / phi_y / gram_a: (..., eta, N); thresh: (eta,),
    (eta, 1), (..., eta, 1) or per vertex (..., eta, N).  A CUDA tensor
    launches the `ista_shrink` kernel (which reads the threshold through
    strides, never expanded), a CPU tensor takes its plain version."""
    thresh = torch.as_tensor(thresh, dtype=a.dtype, device=a.device)
    if thresh.ndim == 1:
        thresh = thresh[:, None]
    return ista_shrink(a, phi_y, gram_a, thresh, gamma=gamma)


def pad_trailing(x: Tensor, total: int) -> Tensor:
    """Zero-pad the last (vertex) axis up to the absolute size `total`;
    leading batch / eta axes pass through untouched."""
    pad = total - x.shape[-1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def pad_for_kernels(x: Tensor, multiple: int = 1024) -> Tensor:
    """Zero-pad the last axis up to a multiple of `multiple`.

    Callers that hold the logical size strip the padding from outputs;
    the execution backends pad to their own layouts internally.
    """
    n = x.shape[-1]
    return pad_trailing(x, n + (-n) % multiple)
