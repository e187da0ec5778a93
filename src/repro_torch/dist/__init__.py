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
  exchange matvec (banded and general partitions), the per-rank plan,
  the option and leak checks.
* :mod:`repro_torch.dist.quantize` — the wire codec of the exchange
  (f32, bf16, int8 with its scale packed into the row; error feedback).
* :mod:`repro_torch.dist.faults` — seeded link faults on the receive side
  of every exchange (`FaultSpec`: drop, stale, bit noise; zero_fill or
  hold_last).
* :mod:`repro_torch.dist.gossip` — Chebyshev consensus on the rank ring
  (`gossip_mean`, `gossip_mean_tree`).
* :mod:`repro_torch.dist.partition` — edge-cut partitions of arbitrary
  sparse graphs (`GeneralPartition`, `partition_general`), the CSR
  container and the million-vertex community graph.
* :mod:`repro_torch.dist.sharding` — logical-axis `ShardingRules` /
  `make_rules` on a `torch.distributed` DeviceMesh: PartitionSpecs, their
  DTensor placements, and the model's sharding constraints.
* :mod:`repro_torch.dist.solvers` — Section-V iterative solvers (Jacobi,
  Chebyshev-accelerated Jacobi, parallel ARMA) behind `plan.solve`,
  running inside every backend via the `matvec_runner` primitive.
"""
from . import (capture, comm, faults, gossip, partition, quantize,
               sharding, solvers)
from .backends import available_backends, get_backend, register_backend
from .comm import (CommStats, plan_comm_stats, solve_comm_stats,
                   verify_message_scaling)
from .faults import DEGRADATIONS, FaultSpec
from .operator import (ExecutionPlan, GraphOperator, as_graph_operator,
                       canonical_kwarg)
from .partition import (CSRMatrix, GeneralPartition, OverfullSlotsError,
                        community_graph_csr, partition_general)
from .sharding import ShardingRules, make_rules
from .solvers import METHODS, SolveResult, solve_plan

__all__ = [
    "CSRMatrix", "CommStats", "DEGRADATIONS", "ExecutionPlan", "FaultSpec",
    "GeneralPartition", "GraphOperator", "METHODS", "OverfullSlotsError",
    "ShardingRules", "SolveResult", "as_graph_operator",
    "available_backends", "canonical_kwarg", "capture", "comm",
    "community_graph_csr", "faults", "get_backend", "gossip",
    "make_rules", "partition", "partition_general", "plan_comm_stats",
    "quantize", "register_backend", "sharding", "solve_comm_stats",
    "solve_plan", "solvers", "verify_message_scaling",
]
