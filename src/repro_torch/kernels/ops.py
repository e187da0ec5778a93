"""Dispatch between the Hopper kernels and the per-order recurrence.

Everything above this module — the `cuda` execution backend, the tests,
``chip_smoke.py`` — calls these functions; the kernel wrappers
(`bcsr_spmv.block_ell_spmv`, `cheb_step.cheb_step`,
`cheb_sweep.cheb_sweep`) pick the CUDA kernel for a CUDA tensor and their
plain PyTorch version for a CPU tensor.

Single-launch sweep dispatch: a matvec tagged with ``mv.block_ell = A``
(a local Block-ELL product) routes the whole K-order loop of
:func:`fused_cheb_recurrence` to :func:`fused_cheb_sweep`: one
cooperative kernel launch for all orders.  The upgrade is guarded by the
L2 footprint model :func:`cheb_sweep_l2_bytes`; a problem over the budget
takes the per-order path (one SpMV launch and one `cheb_step` launch per
order), logged at INFO.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..core.chebyshev import _stateful_matvec
from ..core.graph import BlockELL
from .bcsr_spmv import block_ell_spmv
from .cheb_step import cheb_step
from .cheb_sweep import BF16_ROADMAP, cheb_sweep

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

#: The H100's L2 cache: 50 MiB.  The sweep's reused working set is held
#: against it (see :func:`cheb_sweep_l2_bytes`).
DEFAULT_SWEEP_L2_BUDGET = 50 * 1024 * 1024


def spmv(A: BlockELL, x: Tensor) -> Tensor:
    """Block-ELL y = A @ x on padded signals (..., padded_n).

    One call per Chebyshev order; leading batch dims (batch signals, eta
    streams) ride one sweep of the sparsity structure.
    """
    return block_ell_spmv(A.blocks, A.indices, x)


def cheb_sweep_l2_bytes(n: int, eta: int, batch: int = 1,
                        itemsize: int = 4) -> int:
    """L2 footprint model for one `cheb_sweep` launch on Hopper.

    The sweep keeps nothing on chip across its grid barriers: the iterates
    live in device memory.  What each order re-reads of the order before
    is the reused working set — the three (B, n) iterates (t_{k-1}, read
    by the SpMV of every row block that couples to it, t_{k-2} and the new
    t_k) and the (B, eta, n) accumulator that every order reads and
    writes back:

        (3 + eta) * B * n * itemsize bytes.

    The Block-ELL blocks stream through once per order either way and are
    not counted.  When the working set fits in the 50 MiB L2
    (:data:`DEFAULT_SWEEP_L2_BUDGET`), orders after the first find it on
    chip.
    """
    return (3 + eta) * batch * n * itemsize


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
    (or (K+1,)).  Returns (..., eta, padded_n).  The whole K-order
    recurrence is ONE `cheb_sweep` launch, guarded by
    :func:`cheb_sweep_l2_bytes` against `l2_budget` (default
    :data:`DEFAULT_SWEEP_L2_BUDGET`): a working set over the budget takes
    the per-order path, logged at INFO.  K < 2 takes the per-order path
    too (there is no recurrence to fuse).
    """
    if scratch_dtype not in (None, "f32"):
        if scratch_dtype == "bf16":
            raise NotImplementedError(BF16_ROADMAP)
        raise ValueError(f"scratch_dtype must be 'f32', got {scratch_dtype!r}")
    c = np.atleast_2d(np.asarray(coeffs))
    eta, K1 = c.shape
    K = K1 - 1
    if K < 2:
        return _per_order_cheb(A, x, c, lmax)
    budget = DEFAULT_SWEEP_L2_BUDGET if l2_budget is None else int(l2_budget)
    n = x.shape[-1]
    batch = max(1, x.numel() // n)
    need = cheb_sweep_l2_bytes(n, eta, batch, x.element_size())
    if need > budget:
        logger.info(
            "cheb_sweep: L2 working set %d B exceeds budget %d B "
            "(n=%d, eta=%d, K=%d, B=%d) — falling back to the per-order "
            "cheb_step path", need, budget, n, eta, K, batch)
        return _per_order_cheb(A, x, c, lmax)
    return cheb_sweep(A.blocks, A.indices, x.contiguous(), c,
                      alpha=float(lmax) / 2.0)


def fused_cheb_recurrence(matvec, x: Tensor, coeffs, lmax: float) -> Tensor:
    """Fused shifted-Chebyshev recurrence over an arbitrary matvec.

    A matvec tagged with ``mv.block_ell = A`` (a purely local Block-ELL
    product) routes the whole loop to :func:`fused_cheb_sweep`, padding x
    to A's size and cropping the result; an optional ``mv.l2_budget``
    overrides the sweep budget.  Any other matvec runs the per-order loop.

    x: (..., n); coeffs: (eta, K+1) (or (K+1,), treated as eta=1).
    Returns (..., eta, n).
    """
    A_local = getattr(matvec, "block_ell", None)
    if A_local is not None:
        n_logical = x.shape[-1]
        out = fused_cheb_sweep(
            A_local, pad_trailing(x, A_local.padded_n), coeffs, lmax,
            l2_budget=getattr(matvec, "l2_budget", None))
        return out[..., :n_logical]
    return _cheb_recurrence_loop(matvec, x, coeffs, lmax)


def _cheb_recurrence_loop(matvec, x: Tensor, coeffs, lmax: float) -> Tensor:
    """The per-order recurrence loop (one matvec + one fused step per
    order), with the stateful-matvec protocol of
    `core.chebyshev._stateful_matvec`."""
    c = torch.atleast_2d(torch.as_tensor(np.asarray(coeffs), dtype=x.dtype,
                                         device=x.device))
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
    `cheb_step` loop.
    """
    if sweep is None or sweep:
        return fused_cheb_sweep(A, x, coeffs, lmax, l2_budget=l2_budget,
                                scratch_dtype=scratch_dtype)
    return _per_order_cheb(A, x, np.atleast_2d(np.asarray(coeffs)), lmax)


def pad_trailing(x: Tensor, total: int) -> Tensor:
    """Zero-pad the last (vertex) axis up to the absolute size `total`;
    leading batch / eta axes pass through untouched."""
    pad = total - x.shape[-1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))
