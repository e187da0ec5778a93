"""repro_torch.dist — the execution layer of the port.

* :mod:`repro_torch.dist.operator` — `GraphOperator` / `ExecutionPlan`,
  the unified apply surface (plan/execute split).
* :mod:`repro_torch.dist.backends` — execution strategies behind a
  registry ("dense", "cuda").
"""
from .backends import available_backends, get_backend, register_backend
from .operator import ExecutionPlan, GraphOperator, canonical_kwarg

__all__ = [
    "ExecutionPlan", "GraphOperator", "available_backends",
    "canonical_kwarg", "get_backend", "register_backend",
]
