"""What every sharded backend shares: the option and leak checks, the
ring matvec of the banded backends, and the per-rank plan.

A sharded plan runs on one rank of a `torch.distributed` group and owns
the global rows [rank * nl, (rank + 1) * nl).  Every rank passes the same
global (..., N) signal and gets the same global result: it runs the
recurrence on its own rows with a per-shard matvec and gathers the output
rows onto every rank at the end (`comm.assemble`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import chebyshev as cheb
from ..kernels import ops
from . import comm

Tensor = torch.Tensor


def check_ported_options(exchange_dtype: str, fault_spec, partition) -> None:
    """Raise `NotImplementedError` for the sharded options of later
    slices."""
    if exchange_dtype != "f32":
        raise NotImplementedError(
            f"exchange_dtype={exchange_dtype!r} is not ported to PyTorch yet "
            "(ROADMAP.md, queue 1: item 7, compressed exchange and faults); "
            "the exchange is f32")
    if fault_spec is not None:
        raise NotImplementedError(
            "fault_spec= is not ported to PyTorch yet (ROADMAP.md, queue 1: "
            "item 7, compressed exchange and faults)")
    if isinstance(partition, str) and partition != "banded":
        if partition == "general":
            raise NotImplementedError(
                "partition='general' is not ported to PyTorch yet "
                "(ROADMAP.md, queue 1: item 6, general partitions)")
        raise ValueError(f"unknown partition {partition!r}")


def check_leak(leak: float, n_shards: int, allow_leak: bool) -> None:
    if leak > 1e-10 and not allow_leak:
        raise ValueError(
            f"P is not block-tridiagonal under {n_shards} shards "
            f"(leak={leak:.3e}); spatial_sort the graph first, pass "
            "allow_leak=True, or use backend='allgather'")


def ring_matvec(interior: Callable[[Tensor], Tensor], left: Tensor,
                right: Tensor, nl: int, h: int,
                group) -> Callable[[Tensor], Tensor]:
    """Interior/boundary-split matvec of a banded backend, along the last
    axis of x (..., m), m >= nl (the shard's domain, padded or not):

        y_s = D_s x_s  +  L_s x_{s-1}[-h:]  +  R_s x_{s+1}[:h]

    1. the boundary tiles go on the wire first: rank s sends its last h
       logical entries to s + 1 and its first h to s − 1 (Algorithm 1
       lines 6-7);
    2. `interior` (D_s x_s), which reads no remote data, runs while the
       exchange is in flight;
    3. on arrival, the two (m, h) coupling products `left` and `right`.

    The ring wraps; the first and last shard's wrapped tiles meet zero
    couplings.  With one shard (`group` None) there is nothing to send
    and the matvec is `interior` itself.
    """
    if group is None:
        return interior

    def mv(x: Tensor) -> Tensor:
        pending = comm.ring_exchange(x[..., nl - h:nl], x[..., :h], group)
        y = interior(x)
        from_prev, from_next = pending.wait()
        return (y + torch.matmul(from_prev, left.mT)
                + torch.matmul(from_next, right.mT))

    return mv


def sharded_plan(op, backend: str, mv, *, group, rank: int, nl: int,
                 pnl: int, device: torch.device, dtype: torch.dtype,
                 recurrence, info: dict):
    """An ExecutionPlan whose methods run on this rank's rows with the
    per-shard matvec `mv` and gather the output rows onto every rank.

    `mv` works on the shard's padded domain of `pnl` >= nl entries
    (padded once on the way in, cropped once on the way out).  Every
    signal is cast to `dtype` at the boundary.  `recurrence(mv, x,
    coeffs, lmax)` runs the forward Chebyshev recurrence:
    `cheb.cheb_apply` (plain) or `ops.fused_cheb_recurrence` (the Hopper
    kernels).  Solver and lasso outputs are assembled before anything
    takes a norm over them.
    """
    from ..core.lasso import LassoResult, _mu_threshold, soft_threshold
    from .operator import ExecutionPlan

    n = op.P.shape[0]
    lo = rank * nl
    coeffs, lmax = op.coeffs, op.lmax

    def _local(x) -> Tensor:
        x = torch.as_tensor(x, dtype=dtype, device=device)
        return ops.pad_trailing(x[..., lo:lo + nl], pnl).contiguous()

    def _global(y: Tensor) -> Tensor:
        return comm.assemble(y[..., :nl].contiguous(), group)[..., :n]

    def apply(f) -> Tensor:
        return _global(recurrence(mv, _local(f), np.atleast_2d(coeffs),
                                  lmax))

    def apply_adjoint(a) -> Tensor:
        return _global(cheb.cheb_apply_adjoint(mv, _local(a), coeffs, lmax))

    def apply_gram(f) -> Tensor:
        d = cheb.gram_coeffs(coeffs)[None]
        return _global(recurrence(mv, _local(f), d, lmax)[..., 0, :])

    def solve_lasso(y, mu, gamma, n_iters):
        # the whole ISTA loop on this rank's rows: per iteration the only
        # communication is the exchange rounds of Phi~ Phi~* (Section VI)
        yl = _local(y)
        thresh = _mu_threshold(mu, op.eta, dtype, gamma, device=device)
        phi_y = recurrence(mv, yl, coeffs, lmax)
        a = torch.zeros_like(phi_y)
        for _ in range(n_iters):
            back = cheb.cheb_apply_adjoint(mv, a, coeffs, lmax)
            gram_a = recurrence(mv, back, coeffs, lmax)
            a = soft_threshold(a + gamma * (phi_y - gram_a), thresh)
        y_star = cheb.cheb_apply_adjoint(mv, a, coeffs, lmax)
        return LassoResult(coeffs=_global(a), signal=_global(y_star),
                           objective=torch.full((n_iters,), float("nan"),
                                                dtype=dtype, device=device),
                           n_iters=n_iters, fused=True)

    def matvec_runner(fn, signals, consts=()):
        # the solver bodies run on this rank's rows against the sharded
        # matvec; every output is assembled to the logical n
        outs = fn(mv, *(_local(s) for s in signals), *consts)
        if isinstance(outs, (tuple, list)):
            return type(outs)(_global(o) for o in outs)
        return _global(outs)

    return ExecutionPlan(
        op=op, backend=backend, device=device,
        apply=apply, apply_adjoint=apply_adjoint, apply_gram=apply_gram,
        solve_lasso_fn=solve_lasso, matvec_runner=matvec_runner, info=info)
