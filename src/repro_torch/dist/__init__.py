"""repro_torch.dist — the execution layer of the port.

* :mod:`repro_torch.dist.operator` — `GraphOperator` / `ExecutionPlan`,
  the unified apply surface (plan/execute split).
* :mod:`repro_torch.dist.backends` — execution strategies behind a
  registry ("dense", "cuda").
* :mod:`repro_torch.dist.solvers` — Section-V iterative solvers (Jacobi,
  Chebyshev-accelerated Jacobi, parallel ARMA) behind `plan.solve`,
  running inside every backend via the `matvec_runner` primitive.
"""
from . import solvers
from .backends import available_backends, get_backend, register_backend
from .operator import ExecutionPlan, GraphOperator, canonical_kwarg
from .solvers import METHODS, SolveResult, solve_plan

__all__ = [
    "ExecutionPlan", "GraphOperator", "METHODS", "SolveResult",
    "available_backends", "canonical_kwarg", "get_backend",
    "register_backend", "solve_plan", "solvers",
]
