"""Static and run-time analysis of the port: the invariant checks and the
lint (the JAX package's `repro.analysis`, restated for PyTorch).

Two layers guard the invariants the port's slices settled (the K-round,
2K|E| exchange schedule at every batch size, faults that add no rounds,
sweeps under their L2 model, f32 hot paths without float64 or TF32,
logged fallbacks, the fenced-off LM scaffold, no JAX):

* :mod:`repro_torch.analysis.checks` — run-time checks over eager plan
  calls, reading the exchange events of `dist.comm.counting`, the sweep
  launches and launch counters, and each op's dtypes through a
  `TorchDispatchMode`.  Rule IDs ``RT-*``.
* :mod:`repro_torch.analysis.astlint` — stdlib AST lint over
  `src/repro_torch` and `chip_smoke.py`.  Rule IDs ``RP-*``.

Findings (:class:`Finding`) carry file:line, a stable rule ID and the
enclosing symbol; :class:`Allowlist` (`lint_allowlist.txt` beside this
file) records every tolerated violation with a mandatory justification.
The entry point is ``python -m repro_torch.analysis --check``
(:mod:`repro_torch.analysis.cli`).
"""
from .astlint import AST_RULES, lint_file, lint_source, lint_tree
from .checks import (DTYPE_MIXED_OK, RUNTIME_RULES, check_batch_schedule,
                     check_bijection, check_comm_schedule,
                     check_dtype_discipline, check_fault_schedule,
                     check_l2_budget, check_plan, collective_schedule,
                     exchange_schedule, perm_problems, record_call)
from .findings import (AllowEntry, Allowlist, AllowlistError, Finding,
                       ScaffoldEntry)

ALL_RULES = RUNTIME_RULES + AST_RULES

__all__ = [
    "ALL_RULES",
    "AST_RULES",
    "AllowEntry",
    "Allowlist",
    "AllowlistError",
    "DTYPE_MIXED_OK",
    "Finding",
    "RUNTIME_RULES",
    "ScaffoldEntry",
    "check_batch_schedule",
    "check_bijection",
    "check_comm_schedule",
    "check_dtype_discipline",
    "check_fault_schedule",
    "check_l2_budget",
    "check_plan",
    "collective_schedule",
    "exchange_schedule",
    "lint_file",
    "lint_source",
    "lint_tree",
    "perm_problems",
    "record_call",
]
