"""'cuda' execution backend: sliced-ELL SpMV, fused Chebyshev-step and
whole-recurrence sweep kernels written for Hopper.

The counterpart of the JAX package's 'pallas' backend, with its
contract: the dense P is packed once at plan time into Block-ELL (the
JAX package's structure, kept for its padded size and metadata) and
moved to the plan's device; the sliced-ELL row layout that every kernel
reads — the stand-alone SpMV and both sweeps — is packed from it on the
device when the plan is built (`BlockELL.sliced_ell`, kept on the
Block-ELL); signals are cast to float32 (the packed P's dtype) and
padded to the Block-ELL padded size on the way in, and cropped back to
the logical N on the way out.  By default `apply`
and `apply_gram` send the whole K-order recurrence to the single-launch
`cheb_sweep` kernel, guarded by the L2 footprint model with a logged
per-order fallback (``sweep=False`` / ``l2_budget=`` at plan time
control it); `apply_adjoint` runs one batched sliced-ELL SpMV launch per
order.  The coefficient tables (the union's and the Gram's) are moved to
the device when the plan is built, so no call copies anything from the
host and every plan method can be captured in a CUDA graph
(`dist.capture`).  ``sweep_dtype="bf16"`` runs both sweeps in their
mixed-precision mode (the layout's bf16 values and bf16 iterates, f32
accumulation).  The
plan's matvec is tagged with its Block-ELL structure
(``_mv.block_ell``), its L2 budget and its sweep dtype, so that
`ops.fused_cheb_recurrence` over it engages the sweep and `plan.solve`'s
Jacobi methods reach `ops.fused_jacobi_sweep` (one `jacobi_sweep` launch
per solve), as the JAX package's 'pallas' backend tags its own.

On a CUDA device every kernel launches (or raises); with
``device="cpu"`` the same code runs the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core import chebyshev as cheb
from ...core import graph as graphmod
from ...kernels import ops
from ...kernels.cheb_sweep import check_scratch_dtype
from . import register_backend, resolve_device

Tensor = torch.Tensor


@register_backend("cuda")
def build(op, *, mesh=None, partition=None, device=None,
          block: Tuple[int, int] = (8, 128), sweep: Optional[bool] = None,
          l2_budget: Optional[int] = None,
          sweep_dtype: Optional[str] = None, **options):
    from ..operator import ExecutionPlan

    del mesh, partition  # single-device backend
    if options:
        raise TypeError(f"cuda backend takes no options {sorted(options)}")
    sweep_dtype = sweep_dtype or "f32"
    check_scratch_dtype(sweep_dtype)
    if callable(op.P):
        raise ValueError("cuda backend needs a dense P to build Block-ELL")
    dev = resolve_device(device)
    L = torch.as_tensor(op.P).to(torch.float32).numpy(force=True)
    A = graphmod.to_block_ell(L, block).to(dev)
    n = L.shape[0]
    del L
    total = A.padded_n
    lmax = op.lmax
    # the coefficient tables live on the device from here on: no call
    # copies them from the host (which a captured CUDA graph could not)
    coeffs = torch.as_tensor(op.coeffs, dtype=torch.float32, device=dev)
    gram = torch.as_tensor(cheb.gram_coeffs(op.coeffs)[None],
                           dtype=torch.float32, device=dev)

    def _pad(x) -> Tensor:
        return ops.pad_trailing(
            torch.as_tensor(x, dtype=torch.float32, device=dev), total)

    def _mv(t: Tensor) -> Tensor:
        # batched sliced-ELL SpMV: leading dims (batch, eta streams, ...)
        # ride one pass over the sparsity structure
        return ops.spmv(A, t.contiguous())

    if sweep is None or sweep:
        # tag the matvec so ops.fused_cheb_recurrence and plan.solve's
        # Jacobi methods take the single-launch sweeps
        _mv.block_ell = A
        _mv.l2_budget = l2_budget
        _mv.sweep_dtype = sweep_dtype

    def apply(f) -> Tensor:
        out = ops.fused_cheb_apply(A, _pad(f), coeffs, lmax, sweep=sweep,
                                   l2_budget=l2_budget,
                                   scratch_dtype=sweep_dtype)
        return out[..., :n]

    def apply_adjoint(a) -> Tensor:
        out = cheb.cheb_apply_adjoint(_mv, _pad(a), coeffs, lmax)
        return out[..., :n]

    def apply_gram(f) -> Tensor:
        out = ops.fused_cheb_apply(A, _pad(f), gram, lmax, sweep=sweep,
                                   l2_budget=l2_budget,
                                   scratch_dtype=sweep_dtype)
        return out[..., 0, :n]

    def matvec_runner(fn, signals, consts=()):
        # run the iteration body against the sliced-ELL SpMV on the padded
        # domain; every output's trailing vertex axis is cropped back to n
        outs = fn(_mv, *(_pad(s) for s in signals), *consts)
        if isinstance(outs, (tuple, list)):
            return type(outs)(o[..., :n] for o in outs)
        return outs[..., :n]

    nnz_blocks = int(A.mask.sum())
    S = A.sliced_ell()
    nnz, stored = S.nnz, S.stored
    return ExecutionPlan(
        op=op, backend="cuda", device=dev,
        apply=apply, apply_adjoint=apply_adjoint, apply_gram=apply_gram,
        matvec_runner=matvec_runner,
        info={
            "block": block,
            "padded_n": total,
            "nnz_blocks": nnz_blocks,
            "nnz": nnz,
            # the stand-alone SpMV multiplies every stored sliced-ELL entry
            "stored_per_nnz": stored / max(nnz, 1),
            "flops_per_matvec": 2 * stored,
            "sweep_dtype": sweep_dtype,
            # the guard's model per signal; the guard adds the sliced-ELL
            # layout's values and columns once per launch
            "sweep_l2_bytes": ops.cheb_sweep_l2_bytes(
                total, scratch_dtype=sweep_dtype),
            "sweep_l2_budget": (ops.DEFAULT_SWEEP_L2_BUDGET
                                if l2_budget is None else l2_budget),
            "block_ell": A,
        },
    )
