"""The unified execution API of the port: `GraphOperator` + `ExecutionPlan`.

One object owns the paper's math (coefficients of Eq. (14), error bound of
Prop. 4, message accounting of Section IV) and an explicit *plan* step
picks the execution strategy and the device:

    op = GraphOperator(P, multipliers, lmax=lmax, K=20)
    plan = op.plan("cuda")          # or "dense"; device=None is the card
    out  = plan.apply(f)            # Phi~ f          (..., N) -> (..., eta, N)
    sig  = plan.apply_adjoint(out)  # Phi~* a         (..., eta, N) -> (..., N)
    gr   = plan.apply_gram(f)       # Phi~* Phi~ f    (..., N) -> (..., N)

Signals are ``(..., N)``: leading axes are batch signals sharing the K
rounds of the linear recurrence.  Every backend honours the same
signatures and logical sizes; padding is a backend detail.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.multiplier import UnionMultiplier

Tensor = torch.Tensor


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
    """

    op: UnionMultiplier
    backend: str
    apply: Callable[[Tensor], Tensor]
    apply_adjoint: Callable[[Tensor], Tensor]
    apply_gram: Callable[[Tensor], Tensor]
    device: torch.device
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)
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

    def solve(self, y, method: str = "chebyshev", **kwargs):
        _not_ported("ExecutionPlan.solve", "item 3, Section-V solvers")

    def solve_lasso(self, y, mu, gamma=None, n_iters: int = 300, **kwargs):
        _not_ported("ExecutionPlan.solve_lasso", "item 4, lasso and SSL")


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
