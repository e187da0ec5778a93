"""Memoized plan entries for serving: one CUDA graph per (label, bucket).

The counterpart of the `jax.jit` wrapper that the JAX package's
`ExecutionPlan.compiled` / `compiled_solve` return.  Where jit traces a
plan method once per (shape, dtype) and replays the compiled program,
a :class:`PlanEntry` captures the method once per (shape, dtype) into a
`torch.cuda.CUDAGraph` and replays the graph: one host call launches
every kernel of the method (the sweep, or the adjoint's K SpMVs and
their updates) with no Python, no allocator and no host copy between
them.

The mode of an entry is set by a static rule, :func:`capture_mode`,
before any call, and printed by the callers that report it:

* ``"graph"`` — a ``cuda`` plan on a CUDA device, for the three apply
  kinds and for the solves whose path reads no value on the host
  (``chebyshev``, ``jacobi``, ``cheb_jacobi`` without ``history``,
  ``check_every``, ``x0``, ``den_diag``, ``poles`` or ``residues``).
  At the first call with a new (shape, dtype) the entry runs the method
  once eagerly on a side stream (that builds the kernels, the solver
  setup and its device tables, and warms the allocator), then captures
  it into a static input and output.  Every call copies its input into
  the static input, replays, and returns a NEW tensor (a copy of the
  static output: the next replay overwrites it, so a view would corrupt
  the responses already handed out).  A capture that fails on this path
  raises; the mode is never changed by catching it.
* ``"eager"`` — every other plan: ``device="cpu"``, ``dense``, and the
  sharded ``halo`` / ``cuda_halo`` / ``allgather`` plans, whose exchange
  goes through the host and gloo; and the solves the rule above leaves
  out (``check_every > 0`` reads a residual on the host; ``arma`` copies
  its pole tables per call; ``x0`` / ``den_diag`` arrive per call).  An
  eager entry calls the method; it keeps the same memo and counters.

Counters (per entry):

* ``captures[(shape, dtype)]`` — captures (graph) or first calls (eager)
  at that signature: the counterpart of the trace counter of the JAX
  package's ``tests/test_plan_cache.py``.  A serving loop holds it at 1
  per bucket.
* ``launches[(shape, dtype)]`` — the kernel launches that capture (or
  first call) made, by kernel name.  The kernels' own ``launches``
  counters move at capture only, never at replay.
* ``replays[(shape, dtype)]`` — graph replays at that signature, so the
  launches a served run made are ``launches[key] x replays[key]``.
* ``capture_ms[(shape, dtype)]`` — the host time of warm-up plus capture.

Entries of one plan share one graph memory pool
(``torch.cuda.graph_pool_handle``): their replays run one after another
on the caller's current stream, so the scratch one graph frees at the end
of its capture (the sweep's kept iterates) can serve the next; each
graph's static input and output stay its own.  Do not replay two entries
of one plan concurrently on two streams.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

#: Plan kinds whose entries capture on a `cuda` plan on the card.
APPLY_KINDS = ("apply", "apply_adjoint", "apply_gram")
#: Solve methods whose path (on a `cuda` plan) reads nothing on the host.
GRAPH_SOLVE_METHODS = ("chebyshev", "jacobi", "cheb_jacobi")
#: Solve kwargs that put a solve on the eager side of the rule: per-call
#: host values (x0, den_diag, the ARMA pole tables) or host reads
#: (history's per-round list, check_every's residuals).
_HOST_KWARGS = ("x0", "den_diag", "poles", "residues")


def kernel_counters() -> Tuple[Callable, ...]:
    """Every kernel wrapper of the port that counts its launches."""
    from ..kernels.bcsr_spmv import (sliced_ell_spmv,
                                     sliced_ell_spmv_accumulate)
    from ..kernels.cheb_step import cheb_order, cheb_step
    from ..kernels.cheb_sweep import cheb_sweep, jacobi_sweep
    from ..kernels.flash_attention import (flash_attention_ffma,
                                           flash_attention_wgmma)
    from ..kernels.jacobi_step import jacobi_round, jacobi_step
    from ..kernels.soft_threshold import ista_shrink

    return (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
            cheb_order, cheb_sweep, jacobi_step, jacobi_round, jacobi_sweep,
            ista_shrink, flash_attention_wgmma, flash_attention_ffma)


def _snapshot() -> Dict[str, int]:
    return {k.__name__: k.launches for k in kernel_counters()}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    after = _snapshot()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def capture_mode(plan, kind: str, method: Optional[str] = None,
                 solve_kwargs: Optional[Dict[str, Any]] = None) -> str:
    """The static rule: ``"graph"`` or ``"eager"`` for an entry of `plan`
    (see the module docstring).  Decided from the plan and the kwargs
    alone, before any call."""
    if plan.backend != "cuda" or plan.device.type != "cuda":
        return "eager"
    if kind in APPLY_KINDS:
        return "graph"
    kw = dict(solve_kwargs or {})
    if (method not in GRAPH_SOLVE_METHODS or kw.get("history")
            or int(kw.get("check_every") or 0) > 0
            or any(kw.get(k) is not None for k in _HOST_KWARGS)):
        return "eager"
    return "graph"


class PlanEntry:
    """One memoized plan callable ``batch -> result`` (see the module
    docstring).  fn: the plan method (or solve closure); mode: from
    :func:`capture_mode`; device: the plan's; pool: the plan's shared
    graph pool (graph mode)."""

    def __init__(self, fn: Callable, mode: str, device: torch.device,
                 pool=None, label: Any = None):
        if mode not in ("graph", "eager"):
            raise ValueError(f"mode must be 'graph' or 'eager', got {mode!r}")
        self.fn = fn
        self.mode = mode
        self.device = torch.device(device)
        self.pool = pool
        self.label = label
        self.captures: Dict[Tuple, int] = {}
        self.launches: Dict[Tuple, Dict[str, int]] = {}
        self.replays: Dict[Tuple, int] = {}
        self.capture_ms: Dict[Tuple, float] = {}
        self._graphs: Dict[Tuple, Tuple[Any, Tensor, Tensor]] = {}

    def __repr__(self) -> str:
        return (f"PlanEntry({self.label!r}, mode={self.mode}, "
                f"captures={sum(self.captures.values())})")

    def __call__(self, x):
        if self.mode == "eager":
            return self._eager(x)
        x = torch.as_tensor(x, device=self.device)
        key = (tuple(x.shape), x.dtype)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(x, key)
        g, static_in, static_out = graph
        static_in.copy_(x)
        g.replay()
        self.replays[key] += 1
        return static_out.clone()

    def _eager(self, x):
        shape = tuple(getattr(x, "shape", ()))
        key = (shape, getattr(x, "dtype", None))
        if key in self.captures:
            return self.fn(x)
        before = _snapshot()
        t0 = time.perf_counter()
        out = self.fn(x)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        self.launches[key] = _delta(before)
        self.captures[key] = 1
        return out

    def _capture(self, x: Tensor, key: Tuple):
        t0 = time.perf_counter()
        # one eager run first, on a side stream: builds the kernels, the
        # solver setup and its device tables, and the allocator's blocks
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn(x)
        torch.cuda.current_stream(self.device).wait_stream(side)
        static_in = x.clone()
        g = torch.cuda.CUDAGraph()
        before = _snapshot()
        with torch.cuda.graph(g, pool=self.pool):
            static_out = self.fn(static_in)
        if not isinstance(static_out, Tensor):
            raise TypeError(f"entry {self.label!r} returned "
                            f"{type(static_out).__name__}; a captured entry "
                            "returns one tensor")
        self.launches[key] = _delta(before)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        self.captures[key] = 1
        self.replays[key] = 0
        self._graphs[key] = (g, static_in, static_out)
        return self._graphs[key]
