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


def canonical_solve_items(solve_kwargs: Dict[str, Any]):
    """Sorted ``(name, canonical_kwarg(value))`` tuple for a kwargs dict.

    This IS the kwargs part of the `compiled_solve` memo key;
    `repro_torch.serve` builds its request-compatibility keys from the
    same function, so "same compat key" and "same memoized entry" cannot
    drift apart.
    """
    return tuple((k, canonical_kwarg(v))
                 for k, v in sorted(solve_kwargs.items()))


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
    #: the `torch.distributed` group a sharded plan exchanges over; None
    #: on one shard (what `repro_torch.serve` broadcasts a batch over)
    group: Any = None

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

    # memoized serving entries ---------------------------------------------
    def _entry_cache(self) -> Dict[Any, Any]:
        """Per-plan memo of serving entries (frozen-dataclass __dict__
        idiom, like the operator's coefficient cache)."""
        return self.__dict__.setdefault("_compiled", {})

    def _graph_pool(self):
        """The graph memory pool every captured entry of this plan shares
        (`dist.capture`); None where no entry captures."""
        if self.device.type != "cuda":
            return None
        if "_pool" not in self.__dict__:
            self.__dict__["_pool"] = torch.cuda.graph_pool_handle()
        return self.__dict__["_pool"]

    def _memo_tail(self):
        # The memo is per-plan, but the exchange precision, partition
        # identity and fault spec still join the key, as in the JAX
        # package: plans that share a cache (copy/replace) must never
        # serve each other's entries.
        return (self.info.get("exchange_dtype", "f32"),
                self.info.get("partition_fingerprint",
                              self.info.get("partition", "banded")),
                self.info.get("fault_key", "none"))

    def compiled(self, kind: str = "apply"):
        """Memoized serving entry for a plan method (`dist.capture`).

        ``plan.compiled("apply")`` returns THE SAME
        :class:`~repro_torch.dist.capture.PlanEntry` on every call: on a
        `cuda` plan on the card it captures the method once per (shape,
        dtype) in a CUDA graph and replays it; elsewhere it calls the
        method (``entry.mode``).  The counterpart of the JAX package's
        memoized `jax.jit` wrapper.  kind: ``"apply"`` |
        ``"apply_adjoint"`` | ``"apply_gram"``.
        """
        from .capture import PlanEntry, capture_mode

        fns = {"apply": self.apply, "apply_adjoint": self.apply_adjoint,
               "apply_gram": self.apply_gram}
        if kind not in fns:
            raise KeyError(f"unknown kind {kind!r}; available: "
                           f"{sorted(fns)}")
        key = (kind,) + self._memo_tail()
        cache = self._entry_cache()
        if key not in cache:
            cache[key] = PlanEntry(fns[kind], capture_mode(self, kind),
                                   self.device, pool=self._graph_pool(),
                                   label=kind)
        return cache[key]

    def compiled_solve(self, method: str = "chebyshev", **solve_kwargs):
        """Memoized Section-V solver entry: ``y -> x`` (or ``(x,
        history)`` with ``history=True``).

        Keyed per (method, solver kwargs), exactly as the JAX package
        keys its jitted solver; array-valued kwargs key by value (bytes),
        so every lookup re-hashes them: hold the returned entry in the
        request loop when passing large arrays.  The entry captures (or
        calls) ``plan.solve`` per (shape, dtype); the solver's setup
        (diag(den(P)), rho, the device tables) is paid at its first call.
        """
        from .capture import PlanEntry, capture_mode

        key = (("solve", method) + self._memo_tail()
               + canonical_solve_items(solve_kwargs))
        cache = self._entry_cache()
        if key not in cache:
            history = bool(solve_kwargs.get("history", False))

            def run(y):
                res = self.solve(y, method, **solve_kwargs)
                return (res.x, res.history) if history else res.x

            cache[key] = PlanEntry(
                run, capture_mode(self, "solve", method, solve_kwargs),
                self.device, pool=self._graph_pool(),
                label=("solve", method) + canonical_solve_items(
                    solve_kwargs))
        return cache[key]

    def bucketed_callables(self, buckets, kinds=("apply",), solve_specs=(),
                           n: Optional[int] = None, dtype=None,
                           warm: bool = False):
        """Enumerate the memoized entries a serving loop dispatches onto.

        Returns an ordered dict ``{(label, B): entry}`` where `label` is a
        plan kind (``"apply"`` | ``"apply_adjoint"`` | ``"apply_gram"``)
        or ``("solve", method, *canonical-kwargs)`` for each ``(method,
        kwargs)`` pair in `solve_specs`; the entry takes one ``(B, N)``
        stack (``(B, eta, N)`` for the adjoint).  Entries of one label are
        ONE memoized entry (:meth:`compiled` / :meth:`compiled_solve`)
        holding one capture per bucket.

        ``warm=True`` runs each entry once on zeros of its bucket shape,
        so every capture (and every solver setup) is paid before the first
        request.  `n` defaults to the operator's dense-P dimension (pass
        it for a closure P); dtype defaults to float32.
        """
        import collections

        if n is None:
            if callable(self.op.P):
                raise ValueError(
                    "bucketed_callables needs n= for a closure P")
            n = int(self.op.P.shape[0])
        dtype = dtype or torch.float32
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        entries = collections.OrderedDict()
        for kind in kinds:
            fn = self.compiled(kind)
            lead = (self.op.eta,) if kind == "apply_adjoint" else ()
            for B in buckets:
                entries[(kind, B)] = (fn, (B,) + lead + (int(n),))
        for method, kw in solve_specs:
            kw = dict(kw or {})
            label = ("solve", method) + canonical_solve_items(kw)
            fn = self.compiled_solve(method, **kw)
            for B in buckets:
                entries[(label, B)] = (fn, (B, int(n)))
        out = collections.OrderedDict()
        for (label, B), (fn, shape) in entries.items():
            if warm:
                fn(torch.zeros(shape, dtype=dtype, device=self.device))
            out[(label, B)] = fn
        return out

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


def as_graph_operator(op: UnionMultiplier) -> GraphOperator:
    """Re-wrap any UnionMultiplier as a GraphOperator (shares P, no copy)."""
    if isinstance(op, GraphOperator):
        return op
    return GraphOperator(P=op.P, multipliers=op.multipliers, lmax=op.lmax,
                         K=op.K, coeff_points=op.coeff_points)
