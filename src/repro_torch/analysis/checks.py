"""Run-time invariant checks over the port's plan calls: the JAX package's
`analysis/checks.py`, restated over what the port records while a call
runs instead of over a jaxpr.

The port has no trace, so every check runs the plan method eagerly (never
a captured CUDA graph, whose replay shows no ops) and reads three records:

* the exchange events of :func:`repro_torch.dist.comm.counting`
  (`comm.Recorder.events`: each ``ppermute`` of an offset exchange with
  its ring perm and the pairs this rank sent, each ``all_gather`` and
  output assembly, in call order);
* the sweep launches, seen where `kernels.ops` calls the `cheb_sweep` and
  `jacobi_sweep` wrappers, and the kernels' launch counters;
* every op's floating dtypes and calling frame, from a
  `TorchDispatchMode` around the call.

Rules (the JAX rule each restates in brackets):

* ``RT-EXCHANGE-BIJECTION`` [JX-PPERMUTE-BIJECTION] — every exchange of
  a call is a complete bijection on its group: the pairs every rank
  really sent, gathered over the group, send once and receive once per
  rank (:func:`perm_problems`).
* ``RT-EXCHANGE-DATA-DEPENDENT`` [JX-COLLECTIVE-IN-WHILE] — the ordered
  exchange schedule of a call is the same for two signals of one shape
  (zeros and a seeded draw): a loop whose trip count depends on the data
  shows up as two schedules.  The host-reading solves (``check_every``,
  ``history``, ``arma``) are the deliberate eager entries and are not
  given to this check.
* ``RT-BATCH-SCHEDULE`` [JX-BATCH-SCHEDULE] — the same ordered schedule
  (primitive, ring perm, repeats; payload sizes left out) at every batch
  size: B signals share the K rounds.
* ``RT-FAULT-NO-EXTRA-ROUNDS`` [JX-FAULT-NO-EXTRA-COLLECTIVES] — a plan
  with an active `FaultSpec` runs exactly its clean twin's schedule.
* ``RT-L2-BUDGET`` [JX-VMEM-BUDGET] — every sweep launch of a call fits
  the L2 model the guard uses (`ops.cheb_sweep_l2_bytes`,
  `ops.jacobi_sweep_l2_bytes`) under the plan's budget.  The check reads
  the guard's own functions, so it follows the guard when the model
  changes.
* ``RT-DTYPE-F64`` / ``RT-DTYPE-PROMOTION`` [JX-DTYPE-F64 /
  JX-DTYPE-PROMOTION] — no op of a steady f32 call makes float64, and no
  op other than a cast mixes real floating widths (a bf16 value meeting
  f32 state).  Complex dtypes are exempt (ARMA's complex poles).
  ``RT-DTYPE-MIXED-OK`` [JX-DTYPE-MIXED-OK]: the sanctioned sites of
  :data:`DTYPE_MIXED_OK`, named with their reason.
* ``RT-TF32`` — no TF32 on the f32 path: a call on a card runs with
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` off (`resolve_device` sets both),
  and no f32 matmul (convolution) runs while the matmul (cuDNN) flag is
  on, on any device.

:func:`check_plan` bundles them for one `ExecutionPlan`; a sharded plan's
ranks must call it together (it runs the plan, and gathers each
exchange's pairs over the group).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..dist import comm
from ..kernels import ops
from .findings import Finding

Tensor = torch.Tensor

#: Rule IDs of the run-time layer.
RUNTIME_RULES = (
    "RT-EXCHANGE-BIJECTION",
    "RT-EXCHANGE-DATA-DEPENDENT",
    "RT-BATCH-SCHEDULE",
    "RT-L2-BUDGET",
    "RT-DTYPE-F64",
    "RT-DTYPE-PROMOTION",
    "RT-DTYPE-MIXED-OK",
    "RT-TF32",
    "RT-FAULT-NO-EXTRA-ROUNDS",
)

#: Sanctioned mixed-width and float64 sites (rule ``RT-DTYPE-MIXED-OK``):
#: a dtype finding any of whose port frames (``path::function``) contains
#: the fragment is dropped, with the reason recorded here instead of as
#: allowlist entries.  Keep this list tight — every fragment is a hole in
#: the check.
DTYPE_MIXED_OK = (
    ("repro_torch/kernels/cheb_sweep.py",
     "the bf16 sweeps' wrappers: under scratch_dtype='bf16' the layout's "
     "bf16 values and bf16 iterates meet the f32 coefficient table and "
     "accumulator by design (on the CPU, in their plain versions)"),
)

_REAL_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
#: Ops that convert between widths on purpose: an explicit cast.
_CASTS = {"_to_copy", "copy_", "copy", "to", "_to_dtype"}
#: Ops TF32 applies to: the matmul family, and cuDNN's convolutions.
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
            "matmul", "linear"}
_CONVS = {"convolution", "_convolution", "cudnn_convolution",
          "conv2d", "conv1d", "conv3d"}


def _port_frames(skip: int = 2) -> Tuple[Tuple[str, int, str], ...]:
    """The calling frames inside `src/repro_torch` (this package's own
    analysis modules left out), innermost first, as (repo-relative path,
    line, function)."""
    out = []
    f = sys._getframe(skip)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        i = path.rfind("src/repro_torch/")
        if i >= 0 and "/repro_torch/analysis/" not in path:
            out.append((path[i:], f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def _mixed_ok(frames) -> bool:
    return any(frag in f"{p}::{fn}" for p, _l, fn in frames
               for frag, _why in DTYPE_MIXED_OK)


class OpDtypes(TorchDispatchMode):
    """Records the ops of the calls inside it whose real floating dtypes
    break the dtype rules, or that TF32 could touch while its flag is on:
    each as (op name, input dtypes, rule, port frames)."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, tuple, str, tuple]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        in_f = tuple(a.dtype for a in tree_flatten((args, kwargs))[0]
                     if isinstance(a, Tensor) and a.dtype in _REAL_FLOATS)
        out_f = tuple(a.dtype for a in tree_flatten(out)[0]
                      if isinstance(a, Tensor) and a.dtype in _REAL_FLOATS)
        rules = []
        if torch.float64 in out_f and not (
                in_f and all(d == torch.float64 for d in in_f)):
            rules.append("RT-DTYPE-F64")
        if name not in _CASTS and len({d.itemsize for d in in_f}) > 1:
            rules.append("RT-DTYPE-PROMOTION")
        if torch.float32 in in_f and (
                (name in _MATMULS and torch.backends.cuda.matmul.allow_tf32)
                or (name in _CONVS and torch.backends.cudnn.allow_tf32)):
            rules.append("RT-TF32")
        if rules:
            frames = _port_frames()
            for rule in rules:
                self.records.append((name, in_f, rule, frames))
        return out


class SweepLaunches:
    """Records every call `kernels.ops` makes to the two sweep wrappers
    while it is entered (on a card each is one launch; on the CPU the
    wrapper runs its plain version): (kind, n, batch, itemsize,
    scratch dtype, stored entries)."""

    def __init__(self):
        self.launches: List[Tuple[str, int, int, int, str, int]] = []

    @contextlib.contextmanager
    def patched(self):
        sweep, jacobi = ops.cheb_sweep, ops.jacobi_sweep

        def cheb_sweep(S, x, coeffs, *, alpha, scratch_dtype="f32"):
            n = x.shape[-1]
            self.launches.append(("cheb_sweep", n, max(1, x.numel() // n),
                                  x.element_size(), scratch_dtype,
                                  S.stored))
            return sweep(S, x, coeffs, alpha=alpha,
                         scratch_dtype=scratch_dtype)

        def jacobi_sweep(S, b, inv_d, weights, x0, *, den,
                         scratch_dtype="f32", table=None):
            full = torch.broadcast_shapes(b.shape, x0.shape)
            self.launches.append(("jacobi_sweep", full[-1],
                                  max(1, full[:-1].numel()),
                                  b.element_size(), scratch_dtype,
                                  S.stored))
            return jacobi(S, b, inv_d, weights, x0, den=den,
                          scratch_dtype=scratch_dtype, table=table)

        with mock.patch.object(ops, "cheb_sweep", cheb_sweep), \
                mock.patch.object(ops, "jacobi_sweep", jacobi_sweep):
            yield self


def sweep_l2_bytes(launch) -> int:
    """The guard's L2 model of one recorded sweep launch."""
    kind, n, batch, itemsize, sdt, stored = launch
    model = (ops.cheb_sweep_l2_bytes if kind == "cheb_sweep"
             else ops.jacobi_sweep_l2_bytes)
    return model(n, batch, itemsize, scratch_dtype=sdt, stored=stored)


def kernel_launches() -> Dict[str, int]:
    """The graph kernels' launch counters, as the kernel modules keep
    them (they move on a card only)."""
    from ..kernels.bcsr_spmv import (sliced_ell_spmv,
                                     sliced_ell_spmv_accumulate)
    from ..kernels.cheb_step import cheb_order, cheb_step
    from ..kernels.cheb_sweep import cheb_sweep, jacobi_sweep
    from ..kernels.jacobi_step import jacobi_round, jacobi_step
    from ..kernels.soft_threshold import ista_shrink

    fns = (sliced_ell_spmv, sliced_ell_spmv_accumulate, cheb_step,
           cheb_order, cheb_sweep, jacobi_sweep, jacobi_step, jacobi_round,
           ista_shrink)
    return {f.__name__: f.launches for f in fns}


# ---------------------------------------------------------------------------
# Exchange schedule
# ---------------------------------------------------------------------------
def perm_problems(perm: Sequence[Tuple[int, int]],
                  axis_size: int) -> List[str]:
    """Why `perm` is not a complete bijection on a group of `axis_size`
    ranks (the JAX package's `perm_problems`, naming the same ranks).

    Returns [] for a deadlock-free permutation: every rank sends exactly
    once, receives exactly once, and all indices are in the group.
    """
    problems: List[str] = []
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    off = [i for i in srcs + dsts if not 0 <= i < axis_size]
    if off:
        problems.append(f"indices {sorted(set(off))} outside axis of size "
                        f"{axis_size}")
    if len(set(srcs)) != len(srcs):
        dup = sorted({s for s in srcs if srcs.count(s) > 1})
        problems.append(f"devices {dup} send more than once")
    if len(set(dsts)) != len(dsts):
        dup = sorted({d for d in dsts if dsts.count(d) > 1})
        problems.append(f"devices {dup} receive more than once")
    missing_src = sorted(set(range(axis_size)) - set(srcs))
    missing_dst = sorted(set(range(axis_size)) - set(dsts))
    if missing_src:
        problems.append(f"devices {missing_src} never send")
    if missing_dst:
        problems.append(f"devices {missing_dst} never receive "
                        "(a real interconnect deadlocks)")
    return problems


def exchange_schedule(events: Sequence[comm.Event]) -> Tuple[Tuple, ...]:
    """The ordered schedule of a call's communication: runs of equal
    (primitive, ring perm) as (primitive, perm, repeats).  Payload sizes
    are left out: they scale with the batch, the schedule must not."""
    sched: List[list] = []
    for e in events:
        key = (e.primitive, e.perm)
        if sched and sched[-1][0] == key:
            sched[-1][1] += 1
        else:
            sched.append([key, 1])
    return tuple((p, perm, r) for (p, perm), r in sched)


def bijection_problems(per_rank: Sequence[Sequence[Tuple]],
                       size: int) -> List[Tuple[int, List]]:
    """(index, problems) of each ``ppermute`` of a call that is not a
    complete bijection.  per_rank[r]: rank r's ppermutes in call order,
    each the (src, dst) pairs it sent; the k-th of every rank form one
    exchange.  Ranks that ran different numbers of exchanges are a
    problem of their own."""
    counts = {len(p) for p in per_rank}
    if len(counts) > 1:
        return [(-1, [f"ranks ran {sorted(len(p) for p in per_rank)} "
                      "exchanges: the schedule differs across ranks"])]
    out = []
    for k in range(counts.pop() if counts else 0):
        perm = [pair for p in per_rank for pair in p[k]]
        problems = perm_problems(perm, size)
        if problems:
            out.append((k, problems))
    return out


def check_bijection(events: Sequence[comm.Event],
                    label: str = "fn") -> List[Finding]:
    """RT-EXCHANGE-BIJECTION over the events of one call on this rank.
    With a group, every rank of it must call this together: the pairs are
    gathered over the group."""
    pp = [e for e in events if e.primitive == "ppermute"]
    groups = {id(e.group): e.group for e in events if e.group is not None}
    if not groups:
        return []
    group = next(iter(groups.values()))
    import torch.distributed as dist

    size = dist.get_world_size(group)
    mine = [e.sends for e in pp]
    per_rank: List[Any] = [None] * size
    dist.all_gather_object(per_rank, mine, group=group)
    return [Finding(
        rule="RT-EXCHANGE-BIJECTION", path=label, symbol=label,
        message=(f"exchange {k} of the call is not a complete bijection "
                 f"on the group of {size}: " + "; ".join(problems)))
        for k, problems in bijection_problems(per_rank, size)]


# ---------------------------------------------------------------------------
# One recorded call
# ---------------------------------------------------------------------------
class CallRecord:
    """What one call ran: exchange events, sweep launches, the ops that
    broke a dtype rule, the kernel launch counts, the TF32 flags."""

    def __init__(self, events, sweeps, dtype_records, launches, tf32):
        self.events = events
        self.sweeps = sweeps
        self.dtype_records = dtype_records
        self.launches = launches
        self.tf32 = tf32

    @property
    def schedule(self) -> Tuple[Tuple, ...]:
        return exchange_schedule(self.events)


def record_call(fn: Callable, *args, dtypes: bool = True) -> CallRecord:
    """Run ``fn(*args)`` once with every recorder on."""
    sweeps = SweepLaunches()
    mode = OpDtypes()
    before = kernel_launches()
    with comm.counting() as rec, sweeps.patched():
        with (mode if dtypes else contextlib.nullcontext()):
            fn(*args)
        tf32 = (bool(torch.backends.cuda.matmul.allow_tf32),
                bool(torch.backends.cudnn.allow_tf32))
    after = kernel_launches()
    return CallRecord(rec.events, sweeps.launches, mode.records,
                      {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}, tf32)


def _frame_finding(rule: str, frames, label: str, message: str) -> Finding:
    path, line = (frames[0][0], frames[0][1]) if frames else (label, 0)
    return Finding(rule=rule, path=path, line=line, symbol=label,
                   message=message)


def dtype_findings(record: CallRecord, label: str = "fn",
                   mixed_ok: bool = True) -> List[Finding]:
    """RT-DTYPE-F64 / RT-DTYPE-PROMOTION / the op-level RT-TF32 of one
    recorded call.  ``mixed_ok=True`` drops the dtype findings of the
    sanctioned :data:`DTYPE_MIXED_OK` sites (``False`` shows them raw)."""
    out = []
    seen = set()
    for name, in_f, rule, frames in record.dtype_records:
        if rule != "RT-TF32" and mixed_ok and _mixed_ok(frames):
            continue
        key = (rule, name, frames[:1])
        if key in seen:
            continue
        seen.add(key)
        ins = [str(d).replace("torch.", "") for d in in_f]
        if rule == "RT-DTYPE-F64":
            msg = (f"`{name}` makes float64 on the f32 path (inputs {ins}): "
                   "doubles every payload and leaves the f32 kernels")
        elif rule == "RT-DTYPE-PROMOTION":
            msg = (f"`{name}` mixes real floating widths {sorted(set(ins))}:"
                   " implicit promotion — cast explicitly so the recurrence "
                   "dtype is intentional")
        else:
            msg = (f"`{name}` runs an f32 product while TF32 is allowed: "
                   "f32 mode must not quietly round to TF32")
        out.append(_frame_finding(rule, frames, label, msg))
    return out


def l2_findings(record: CallRecord, budget: int,
                label: str = "fn") -> List[Finding]:
    """RT-L2-BUDGET: every sweep launch of the call fits `budget`."""
    out = []
    for launch in record.sweeps:
        need = sweep_l2_bytes(launch)
        if need > budget:
            kind, n, batch, _i, sdt, stored = launch
            out.append(Finding(
                rule="RT-L2-BUDGET", path=label, symbol=label,
                message=(f"{kind} launch (n={n}, B={batch}, {sdt}, "
                         f"{stored} stored entries) has an L2 working set "
                         f"of {need} B over the budget {budget} B — the "
                         "guard must send it to the per-order path")))
    return out


def tf32_findings(record: CallRecord, device: torch.device,
                  label: str = "fn") -> List[Finding]:
    """The call-level RT-TF32: a call on a card runs with both TF32 flags
    off."""
    if device.type != "cuda" or not any(record.tf32):
        return []
    flags = [f for f, on in zip(("torch.backends.cuda.matmul.allow_tf32",
                                 "torch.backends.cudnn.allow_tf32"),
                                record.tf32) if on]
    return [Finding(rule="RT-TF32", path=label, symbol=label,
                    message=f"a call on the card ran with {flags} on: f32 "
                            "mode must not quietly use TF32")]


def schedule_finding(rule: str, label: str, got, want,
                     what: str) -> List[Finding]:
    if got == want:
        return []
    return [Finding(rule=rule, path=label, symbol=label,
                    message=(f"exchange schedule {what} ({len(got)} vs "
                             f"{len(want)} runs of equal exchanges): "
                             + _SCHEDULE_WHY[rule]))]


_SCHEDULE_WHY = {
    "RT-EXCHANGE-DATA-DEPENDENT": (
        "a loop whose trip count depends on the data runs exchanges, so "
        "the rounds cannot be counted ahead of the call"),
    "RT-BATCH-SCHEDULE": (
        "the batched path re-runs or re-orders the exchange rounds "
        "instead of sharing them across the batch"),
    "RT-FAULT-NO-EXTRA-ROUNDS": (
        "faults must be receiver-side value substitutions after the "
        "exchange, never extra rounds or reordered exchanges — the 2K|E| "
        "accounting depends on it"),
}


# ---------------------------------------------------------------------------
# Checks over callables (the planted-violation entry points)
# ---------------------------------------------------------------------------
def _draw(shape, seed: int, device) -> Tensor:
    """A seeded f32 draw, the same on every rank."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def collective_schedule(fn: Callable, *args) -> Tuple[Tuple, ...]:
    """The ordered exchange schedule of one call of ``fn(*args)``
    (:func:`exchange_schedule`)."""
    return record_call(fn, *args, dtypes=False).schedule


def check_comm_schedule(fn: Callable, *args,
                        label: str = "fn") -> List[Finding]:
    """RT-EXCHANGE-BIJECTION over one call of ``fn(*args)``, and
    RT-EXCHANGE-DATA-DEPENDENT: the same call on zeros of the same shapes
    runs the same schedule.  With a group, every rank calls it
    together."""
    rec = record_call(fn, *args, dtypes=False)
    zeros = record_call(fn, *(torch.zeros_like(a) for a in args),
                        dtypes=False)
    return (check_bijection(rec.events, label)
            + schedule_finding("RT-EXCHANGE-DATA-DEPENDENT", label,
                               rec.schedule, zeros.schedule,
                               "differs between zeros and another signal "
                               "of one shape"))


def check_batch_schedule(fn_for_batch: Callable[[int], Tuple[Callable,
                                                              tuple]],
                         batches: Sequence[int] = (1, 64),
                         label: str = "fn") -> List[Finding]:
    """RT-BATCH-SCHEDULE: `fn_for_batch(B)` returns ``(fn, args)`` for
    batch size B; the schedules at every B must be identical."""
    fn, args = fn_for_batch(batches[0])
    ref = collective_schedule(fn, *args)
    out = []
    for b in batches[1:]:
        fn, args = fn_for_batch(b)
        out += schedule_finding("RT-BATCH-SCHEDULE", label,
                                collective_schedule(fn, *args), ref,
                                f"at B={b} differs from B={batches[0]}")
    return out


def check_dtype_discipline(fn: Callable, *args,
                           label: str = "fn") -> List[Finding]:
    """RT-DTYPE-F64 / RT-DTYPE-PROMOTION / RT-TF32 over one call of
    ``fn(*args)`` (call it once before, so that the recorded call is a
    steady one)."""
    return dtype_findings(record_call(fn, *args), label)


def check_l2_budget(fn: Callable, *args, budget: Optional[int] = None,
                    label: str = "fn") -> List[Finding]:
    """RT-L2-BUDGET over one call of ``fn(*args)``."""
    budget = ops.DEFAULT_SWEEP_L2_BUDGET if budget is None else int(budget)
    return l2_findings(record_call(fn, *args, dtypes=False), budget, label)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
def _logical_n(plan, n: Optional[int]) -> int:
    if n is not None:
        return int(n)
    if callable(plan.op.P):
        raise ValueError("n= is needed for a closure P")
    return int(plan.op.P.shape[0])


def _targets(plan, n: int, solve_methods: Sequence[str]):
    """(name, fn, shape for a batch of B) of every checked method."""
    eta = plan.op.eta
    out = [("apply", plan.apply, lambda b: (b, n)),
           ("apply_adjoint", plan.apply_adjoint, lambda b: (b, eta, n)),
           ("apply_gram", plan.apply_gram, lambda b: (b, n))]
    for method in solve_methods:
        def _solve(y, _m=method):
            return plan.solve(y, _m, tau=0.5).x

        out.append((f"solve[{method}]", _solve, lambda b: (b, n)))
    return out


def check_plan(plan, n: Optional[int] = None,
               batches: Sequence[int] = (1, 64),
               budget: Optional[int] = None,
               solve_methods: Sequence[str] = (),
               report: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """Run every run-time check over one `ExecutionPlan`.

    Each of apply / apply_adjoint / apply_gram (and ``plan.solve(y,
    method, tau=0.5)`` for each of `solve_methods`) runs at every B of
    `batches`, on zeros and then on a seeded draw of (B, N) (or (B, eta,
    N)): the zeros call warms the call up, the draw's call is recorded
    (dtypes, sweep launches, TF32, exchanges) and both schedules are
    compared (data dependence), then the schedules across B.  Findings
    carry ``symbol = "<backend>.<method>"``.  `budget` defaults to the
    plan's ``sweep_l2_budget`` (else the default).  `report`, a dict,
    receives the calls run and the kernel launches they made.
    """
    n = _logical_n(plan, n)
    if budget is None:
        budget = plan.info.get("sweep_l2_budget", ops.DEFAULT_SWEEP_L2_BUDGET)
    dev = plan.device
    findings: List[Finding] = []
    calls = 0
    launches: Dict[str, int] = {}
    for name, fn, shape_of in _targets(plan, n, solve_methods):
        label = f"{plan.backend}.{name}"
        ref_sched = None
        for b in batches:
            shape = shape_of(b)
            zero = record_call(fn, torch.zeros(shape, device=dev),
                               dtypes=False)
            rec = record_call(fn, _draw(shape, b, dev))
            calls += 2
            for rc in (zero, rec):
                for k, v in rc.launches.items():
                    launches[k] = launches.get(k, 0) + v
            findings += check_bijection(rec.events, label)
            findings += dtype_findings(rec, label)
            findings += tf32_findings(rec, dev, label)
            findings += l2_findings(rec, budget, label)
            findings += schedule_finding(
                "RT-EXCHANGE-DATA-DEPENDENT", label, rec.schedule,
                zero.schedule, f"at B={b} differs between zeros and a "
                "seeded draw")
            if ref_sched is None:
                ref_sched = rec.schedule
            else:
                findings += schedule_finding(
                    "RT-BATCH-SCHEDULE", label, rec.schedule, ref_sched,
                    f"at B={b} differs from B={batches[0]}")
    if report is not None:
        report["calls"] = report.get("calls", 0) + calls
        tally = report.setdefault("launches", {})
        for k, v in launches.items():
            tally[k] = tally.get(k, 0) + v
    return findings


def check_fault_schedule(clean_plan, faulted_plan, n: Optional[int] = None,
                         solve_methods: Sequence[str] = ()
                         ) -> List[Finding]:
    """RT-FAULT-NO-EXTRA-ROUNDS: the faulted plan's apply / apply_adjoint /
    apply_gram (and each solve of `solve_methods`) run exactly the clean
    plan's ordered exchange schedule, on the same seeded signal."""
    n = _logical_n(clean_plan, n)
    fkey = faulted_plan.info.get("fault_key", "none")
    findings: List[Finding] = []
    for (name, clean_fn, shape_of), (_n, faulted_fn, _s) in zip(
            _targets(clean_plan, n, solve_methods),
            _targets(faulted_plan, n, solve_methods)):
        label = f"{faulted_plan.backend}.{name}"
        x = _draw(shape_of(1)[1:], 1, clean_plan.device)
        ref = record_call(clean_fn, x, dtypes=False).schedule
        got = record_call(faulted_fn, x, dtypes=False).schedule
        findings += schedule_finding(
            "RT-FAULT-NO-EXTRA-ROUNDS", label, got, ref,
            f"of the fault-injected plan ({fkey}) differs from the clean "
            "plan's")
    return findings
