"""The unified execution API of the port: `GraphOperator` + `ExecutionPlan`.

One object owns the paper's math (coefficients of Eq. (14), error bound of
Prop. 4, message accounting of Section IV) and an explicit *plan* step
picks the execution strategy and the device:

    op = GraphOperator(P, multipliers, lmax=lmax, K=20)
    plan = op.plan("cuda")          # or "dense"; device=None is the card
    # or sharded over a torch.distributed group, one rank per shard:
    # op.plan("cuda_halo", mesh=group) | "halo" | "allgather"
    out  = plan.apply(f)            # Phi~ f          (..., N) -> (..., eta, N)
    sig  = plan.apply_adjoint(out)  # Phi~* a         (..., eta, N) -> (..., N)
    gr   = plan.apply_gram(f)       # Phi~* Phi~ f    (..., N) -> (..., N)
    res  = plan.solve(y, "jacobi", tau=0.5)   # Section V: x = g(P) y
    las  = plan.solve_lasso(y, mu)            # Algorithm 3 (wavelet lasso)

Signals are ``(..., N)``: leading axes are batch signals sharing the K
rounds of the linear recurrence.  Every backend honours the same
signatures and logical sizes; padding is a backend detail.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.multiplier import UnionMultiplier

Tensor = torch.Tensor

logger = logging.getLogger(__name__)


def canonical_kwarg(v) -> Any:
    """Hashable, collision-free canonical form of one solver kwarg value.

    Array-valued kwargs (numpy arrays and tensors) key by (shape, dtype,
    bytes), so two solves of different systems never share a memo entry.
    ``bool`` is tagged before the numeric paths because ``True == 1`` (and
    hashes equal).
    """
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, (list, tuple)):
        return tuple(canonical_kwarg(x) for x in v)
    if isinstance(v, Tensor):
        v = v.numpy(force=True)
    if hasattr(v, "shape") or type(v).__module__ == "numpy":
        a = np.asarray(v)
        return (a.shape, str(a.dtype), a.tobytes())
    return v


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, queue 1: {item})")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """An execution-strategy view of one GraphOperator on one device.

    `apply` / `apply_adjoint` / `apply_gram` are closures with the uniform
    signatures documented on :class:`GraphOperator`; they accept tensors
    or numpy arrays and return tensors on `device`.  `info` carries
    backend-specific cost metadata.  `matvec_runner(fn, signals,
    consts=())` runs ``fn(mv, *signals, *consts)`` against this backend's
    matvec on its padded domain and crops outputs to the logical N.
    `solve_lasso_fn(y, mu, gamma, n_iters)`, where a backend sets it, runs
    the whole ISTA loop fused: the sharded backends set it (the loop on
    each rank's rows); both single-device backends leave it None and
    `solve_lasso` takes the generic loop.
    """

    op: UnionMultiplier
    backend: str
    apply: Callable[[Tensor], Tensor]
    apply_adjoint: Callable[[Tensor], Tensor]
    apply_gram: Callable[[Tensor], Tensor]
    device: torch.device
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    solve_lasso_fn: Optional[Callable] = None
    matvec_runner: Optional[Callable] = None

    # mirrored operator metadata -------------------------------------------
    @property
    def eta(self) -> int:
        return self.op.eta

    @property
    def K(self) -> int:
        return self.op.K

    @property
    def lmax(self) -> float:
        return self.op.lmax

    @property
    def coeffs(self):
        return self.op.coeffs

    def error_bound(self) -> float:
        return self.op.error_bound()

    def message_counts(self, n_edges: int) -> dict:
        return self.op.message_counts(n_edges)

    # later slices of the port -----------------------------------------------
    def compiled(self, kind: str = "apply"):
        _not_ported("ExecutionPlan.compiled", "item 9, serving")

    def compiled_solve(self, method: str = "chebyshev", **solve_kwargs):
        _not_ported("ExecutionPlan.compiled_solve", "item 9, serving")

    def bucketed_callables(self, buckets, **kwargs):
        _not_ported("ExecutionPlan.bucketed_callables", "item 9, serving")

    # Section V solvers -----------------------------------------------------
    def solve(self, y, method: str = "chebyshev", **kwargs):
        """Apply x = g(P) y by a Section-V iterative method.

        The solver problem is the rational filter g = num/den (monomial
        coefficients, low-degree-first) — equivalently: solve
        ``den(P) x = num(P) y`` (Eq. (23), Q = g(P)^{-1}).  Sugar: pass
        ``tau=`` (+ ``r=``, ``h_scale=``) for the Tikhonov/SSL family
        g = tau / (tau + h_scale * lambda^r); named specs live in
        `repro_torch.core.filters`.

        method: ``"chebyshev"`` (Section IV truncated approximation, order
        n_iters), ``"jacobi"`` (Eq. (24)), ``"cheb_jacobi"`` (Eq. (25);
        needs rho < 1, estimated if omitted), ``"arma"`` (Eqs. (29)-(30);
        |p_k| > lmax/2 required for convergence).

        y: (..., N) batched signals — every signal shares the rounds; on
        the `cuda` backend a Jacobi solve is one `jacobi_sweep` launch.
        Returns a :class:`repro_torch.dist.solvers.SolveResult`
        (``history=True`` records the per-round iterates).  Keyword
        reference: :func:`repro_torch.dist.solvers.solve_plan`.
        """
        from .solvers import solve_plan

        return solve_plan(self, y, method, **kwargs)

    # Algorithm 3 -----------------------------------------------------------
    def solve_lasso(self, y, mu, gamma: Optional[float] = None,
                    n_iters: int = 300, **kwargs):
        """Wavelet lasso (Section VI, Algorithm 3) under this plan.

        y: (..., N) — batched signals share every round; mu: scalar,
        (eta,) per-scale, (..., eta) per-signal or (..., eta, N)
        per-vertex weights; gamma defaults to
        `core.lasso.ista_step_size`.

        A backend that fuses the whole ISTA loop sets `solve_lasso_fn`;
        kwargs that *change* the loop (a0, record_objective,
        soft_threshold_fn, ...) route to the generic ISTA over this plan's
        apply/apply_adjoint instead — kwargs passed at their default values
        are benign and keep fusion.  Every forfeit is logged (INFO), and
        `LassoResult.fused` records which path ran.  Both single-device
        backends run the generic loop, whose shrinkage step is the
        `ista_shrink` kernel on the card; the sharded backends run the
        fused loop on each rank's rows, with the JAX package's plain
        `soft_threshold`.
        """
        from ..core import lasso as _lasso

        if gamma is None:
            gamma = _lasso.ista_step_size(self.op)
        if self.solve_lasso_fn is not None:
            # drop benign kwargs (== the generic-ISTA defaults); only
            # genuinely loop-changing kwargs forfeit the fused path
            benign = {"a0": None, "record_objective": False,
                      "soft_threshold_fn": _lasso.soft_threshold}
            blocking = {k: v for k, v in kwargs.items()
                        if not (k in benign and v is benign[k])}
            # per-vertex mu ((..., eta, N): trailing axis is N, not eta)
            # also runs the generic loop
            mu_arr = torch.as_tensor(mu)
            if mu_arr.ndim >= 2 and mu_arr.shape[-1] != self.op.eta:
                blocking["mu"] = f"per-vertex, shape {tuple(mu_arr.shape)}"
            if not blocking:
                return self.solve_lasso_fn(y, mu, gamma, n_iters)
            logger.info(
                "solve_lasso[%s]: %s forfeit the fused ISTA; running the "
                "generic (unfused) loop", self.backend, sorted(blocking))
        return _lasso.distributed_lasso(self, y, mu=mu, gamma=gamma,
                                        n_iters=n_iters, **kwargs)


@dataclasses.dataclass(frozen=True)
class GraphOperator(UnionMultiplier):
    """Union of graph multiplier operators with pluggable execution.

    Construction computes the truncated shifted-Chebyshev coefficients once
    (Eq. (14)); `.plan(backend=..., device=...)` binds an execution
    strategy.  Uniform plan signatures across backends:

        plan.apply(f)          f: (..., N)      ->  (..., eta, N)
        plan.apply_adjoint(a)  a: (..., eta, N) ->  (..., N)
        plan.apply_gram(f)     f: (..., N)      ->  (..., N)
    """
