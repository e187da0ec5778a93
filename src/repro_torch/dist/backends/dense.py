"""'dense' execution backend: Algorithm 1/2 against P as given.

P is a dense matrix (moved once to the plan's device, at its own dtype,
which every signal is cast to on the way in) or a matvec closure applying
P along the last axis (signals keep their dtype).  The product is a
plain `torch.matmul` outside any kernel of this package, as the JAX
package left it to XLA.  This is the single-device reference path with
the batched (..., N) contract.
"""
from __future__ import annotations

import torch

from ...core import chebyshev as cheb
from . import register_backend, resolve_device

Tensor = torch.Tensor


@register_backend("dense")
def build(op, *, mesh=None, partition=None, device=None, **options):
    from ..operator import ExecutionPlan

    del mesh, partition  # single-device backend
    if options:
        raise TypeError(f"dense backend takes no options {sorted(options)}")
    dev = resolve_device(device)
    dtype = None
    if callable(op.P):
        mv = op.P
    else:
        P = torch.as_tensor(op.P).to(dev)
        dtype = P.dtype

        def mv(x: Tensor) -> Tensor:
            return torch.matmul(x, P.mT)

    coeffs = op.coeffs
    lmax = op.lmax

    def _in(x) -> Tensor:
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def apply(f) -> Tensor:
        return cheb.cheb_apply(mv, _in(f), coeffs, lmax)

    def apply_adjoint(a) -> Tensor:
        return cheb.cheb_apply_adjoint(mv, _in(a), coeffs, lmax)

    def apply_gram(f) -> Tensor:
        return cheb.cheb_apply_gram(mv, _in(f), coeffs, lmax)

    def matvec_runner(fn, signals, consts=()):
        # the logical N is the execution domain: no padding or cropping
        return fn(mv, *(_in(s) for s in signals), *consts)

    return ExecutionPlan(
        op=op, backend="dense", device=dev,
        apply=apply, apply_adjoint=apply_adjoint, apply_gram=apply_gram,
        matvec_runner=matvec_runner,
        info={"matvecs_per_apply": op.K},
    )
