"""repro_torch.dist — the execution layer of the port.

* :mod:`repro_torch.dist.operator` — `GraphOperator` / `ExecutionPlan`,
  the unified apply surface (plan/execute split).
* :mod:`repro_torch.dist.backends` — execution strategies behind a
  registry ("dense", "cuda" on one device; "halo", "cuda_halo",
  "allgather" sharded over a `torch.distributed` process group).
* :mod:`repro_torch.dist.comm` — every send, receive and gather of the
  sharded plans, and their count (`CommStats`, `plan_comm_stats`,
  `verify_message_scaling`): the paper's 2K|E| messages made measurable.
* :mod:`repro_torch.dist.sharded` — what the sharded backends share: the
  ring matvec, the per-rank plan, the option and leak checks.
* :mod:`repro_torch.dist.partition` — `OverfullSlotsError` (the general
  partitions are a later slice).
* :mod:`repro_torch.dist.solvers` — Section-V iterative solvers (Jacobi,
  Chebyshev-accelerated Jacobi, parallel ARMA) behind `plan.solve`,
  running inside every backend via the `matvec_runner` primitive.
"""
from . import comm, partition, solvers
from .backends import available_backends, get_backend, register_backend
from .comm import (CommStats, plan_comm_stats, solve_comm_stats,
                   verify_message_scaling)
from .operator import ExecutionPlan, GraphOperator, canonical_kwarg
from .partition import OverfullSlotsError
from .solvers import METHODS, SolveResult, solve_plan

__all__ = [
    "CommStats", "ExecutionPlan", "GraphOperator", "METHODS",
    "OverfullSlotsError", "SolveResult", "available_backends",
    "canonical_kwarg", "comm", "get_backend", "partition",
    "plan_comm_stats", "register_backend", "solve_comm_stats", "solve_plan",
    "solvers", "verify_message_scaling",
]
